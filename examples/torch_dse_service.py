"""DSE-as-a-service demo on the PyTorch/CUDA port: a burst of mixed
sweep queries — different networks, budgets, objectives, inference and
training — submitted from several client threads to one ``DSEService``
over a study whose grid reductions run on the card (``torch-fused``),
which coalesces them onto shared cost tables and fans the answers back
out.  Ends by printing the ``ServiceStats`` snapshot (coalescing ratio,
batch occupancy, latency percentiles, table/store hit rates) and
demonstrating that a poisoned request fails alone with a structured
error.  Runs on the CUDA card; ``--device cpu`` runs the reductions'
plain versions instead (without a card and without it, it raises).  It
prints the lines of ``examples/dse_service.py``.

  PYTHONPATH=src python examples/torch_dse_service.py [--device cpu]
"""
import argparse
import threading

from repro_torch.core import INFER_PRESETS, Study, Workload
from repro_torch.core.layers import ConvLayer, batch_norm, fc, relu
from repro_torch.serve import DSEClient, DSERequest, DSEService, ServiceError


def tiny_train_net():
    def conv(name, **kw):
        base = dict(name=name, n=1, ic=16, ih=16, iw=16, oc=32, oh=16,
                    ow=16, kh=3, kw=3, s=1, has_bias=False)
        base.update(kw)
        return ConvLayer(**base)
    return (conv("c1"), batch_norm("c1.bn", 16, 16, 1, 32),
            relu("c1.relu", 16, 16, 1, 32), conv("c2", ic=32, oc=32),
            fc("fc", 1, 2048, 10))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device
    study = Study(INFER_PRESETS[16], sizes=(32, 64, 128, 256),
                  bws=(32, 64, 128, 256), tol=0.5, store=None,
                  backend="torch-fused", device=device)
    train = Workload(net=tiny_train_net(), training=True, name="tiny-train")
    burst = [
        DSERequest("resnet18", 512, 256, objective="cycles", tag="r18/cyc"),
        DSERequest("resnet18", 256, 256, objective="edp", tag="r18/edp"),
        DSERequest("alexnet", 512, 256, objective="edp", tag="alex/edp"),
        DSERequest("alexnet", 256, 256, objective="cycles", tag="alex/cyc"),
        DSERequest(train, 512, 256, objective="cycles", tag="train/cyc"),
        DSERequest(train, 256, 256, objective="edp", tag="train/edp"),
        DSERequest("resnet18", 512, 256, objective="cycles", tag="dup"),
        DSERequest("no_such_net", 512, 256, tag="poisoned"),
    ]

    # autostart=False: submit the whole burst first, then start the
    # dispatcher, so it lands in one micro-batch (maximal coalescing).
    svc = DSEService(study, autostart=False, max_batch=len(burst))
    client = DSEClient(svc)
    tickets = [None] * len(burst)

    def submitter(tid, stride=4):
        for i in range(tid, len(burst), stride):
            tickets[i] = client.submit(burst[i])

    threads = [threading.Thread(target=submitter, args=(t,))
               for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    svc.start()

    print("== responses ==")
    for req, ticket in zip(burst, tickets):
        try:
            res = ticket.result(timeout=600)
            print(f"  {req.tag:>10}: sizes_kb={res.best.sizes_kb} "
                  f"bws={res.best.bws} cycles={res.best.cycles}")
        except ServiceError as exc:
            print(f"  {req.tag:>10}: FAILED kind={exc.kind} ({exc.message})")
    svc.close()

    print("== service stats ==")
    st = svc.stats()
    print(" ", st.summary())
    print(f"  searches={st.searches} for priced={st.priced_requests} "
          f"requests (+{st.dedup_hits} dedup) -> "
          f"coalescing {st.coalescing_ratio:.2f}x, "
          f"occupancy {st.batch_occupancy:.2f}")


if __name__ == "__main__":
    main()
