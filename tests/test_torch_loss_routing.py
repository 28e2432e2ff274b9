"""``Model.loss(..., routing=...)``: the MoE choices of a training step
recorded and replayed (``models.moe.Routing``), the seam through which
``chip_smoke.py`` holds a MoE model's kernel-route step against the plain
route on the same choices.  Reduced MoE configs in float32 on the CPU.

* ``routing=None`` is the loss as it was; a recording ``Routing()``
  changes nothing and keeps one ``(nblk, blk, k)`` choice tensor per MoE
  layer.
* Replaying those choices gives the same loss and the same gradients,
  bit for bit.
* Replayed into another model (other router weights), the choices are
  taken in place of its own: its loss differs from its own unpinned
  loss, and equals a second replay.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models.moe import Routing  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402

MOE = ["granite-moe-1b-a400m", "llama4-maverick-400b-a17b"]


def _setup(arch, seed=0):
    cfg = reduced(get_config(arch)).replace(dtype=torch.float32,
                                            remat=False)
    params = train.trainable(
        Model(cfg).init(torch.Generator().manual_seed(seed)))
    tokens = torch.randint(0, cfg.vocab_size, (2, 40),
                           generator=torch.Generator().manual_seed(1))
    return cfg, params, {"tokens": tokens}


def _step(model, params, batch, routing=None):
    loss, metrics = model.loss(params, batch, routing=routing)
    grads = torch.autograd.grad(loss, train.leaves(params))
    return loss.detach(), metrics["aux"].detach(), grads


@pytest.mark.parametrize("arch", MOE)
def test_recording_changes_nothing(arch):
    cfg, params, batch = _setup(arch)
    model = Model(cfg)
    loss, aux, grads = _step(model, params, batch)
    plain_loss, _ = model.loss(params, batch)
    assert torch.equal(loss, plain_loss.detach())
    chosen = Routing()
    rloss, raux, rgrads = _step(model, params, batch, chosen)
    assert torch.equal(loss, rloss) and torch.equal(aux, raux)
    assert all(torch.equal(a, b) for a, b in zip(grads, rgrads))
    moe_layers = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    assert len(chosen.choices) == moe_layers > 0
    for idx in chosen.choices:
        assert idx.dim() == 3 and idx.shape[-1] == cfg.top_k


@pytest.mark.parametrize("arch", MOE)
def test_replayed_choices_give_the_same_loss_and_gradients(arch):
    cfg, params, batch = _setup(arch)
    model = Model(cfg)
    chosen = Routing()
    loss, aux, grads = _step(model, params, batch, chosen)
    replay = chosen.pinned()
    again, again_aux, again_grads = _step(model, params, batch, replay)
    assert replay.calls == len(chosen.choices)
    assert torch.equal(loss, again) and torch.equal(aux, again_aux)
    assert all(torch.equal(a, b) for a, b in zip(grads, again_grads))


@pytest.mark.parametrize("arch", MOE)
def test_replayed_choices_replace_another_models_own(arch):
    cfg, params, batch = _setup(arch)
    _, other, _ = _setup(arch, seed=5)
    model = Model(cfg)
    chosen = Routing()
    _step(model, params, batch, chosen)
    own = Routing()
    own_loss, _, _ = _step(model, other, batch, own)
    assert any(not torch.equal(a.sort(-1).values, b.sort(-1).values)
               for a, b in zip(chosen.choices, own.choices))
    pinned_loss, _, g1 = _step(model, other, batch, chosen.pinned())
    second, _, g2 = _step(model, other, batch, chosen.pinned())
    assert not torch.equal(pinned_loss, own_loss)
    assert torch.equal(pinned_loss, second)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
