"""The port's watchdog (``repro_torch.distributed.fault.Watchdog``, an own
copy of the JAX package's ``repro.distributed.fault``): the five
behaviours ``tests/test_fault.py`` holds there."""
import time

from repro_torch.distributed.fault import Watchdog


def test_fires_on_stall():
    fired = []
    wd = Watchdog(timeout_s=0.2, on_stall=lambda idle: fired.append(idle))
    with wd:
        time.sleep(0.5)
    assert fired and fired[0] >= 0.2


def test_silent_with_beats():
    fired = []
    wd = Watchdog(timeout_s=0.3, on_stall=lambda idle: fired.append(idle))
    with wd:
        for _ in range(5):
            time.sleep(0.1)
            wd.beat()
    assert not fired


def test_fires_once():
    fired = []
    wd = Watchdog(timeout_s=0.1, on_stall=lambda idle: fired.append(idle))
    with wd:
        time.sleep(0.45)
    assert len(fired) == 1


def test_beat_rearms_for_second_stall():
    """A beat after a stall re-arms the latch: a second stall later in
    the same run fires again."""
    fired = []
    wd = Watchdog(timeout_s=0.1, on_stall=lambda idle: fired.append(idle))
    with wd:
        time.sleep(0.3)              # first stall
        assert len(fired) == 1
        wd.beat()                    # recovery heartbeat
        time.sleep(0.3)              # second stall
    assert len(fired) == 2


def test_no_fire_after_stop():
    """Once stopped, the callback never fires, even mid-stall; the
    thread is gone."""
    fired = []
    wd = Watchdog(timeout_s=0.05, on_stall=lambda idle: fired.append(idle))
    wd.start()
    wd.stop()
    n = len(fired)
    time.sleep(0.3)
    assert len(fired) == n
    assert not wd._thread.is_alive()
