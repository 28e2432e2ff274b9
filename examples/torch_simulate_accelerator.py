"""SimDIT demo on the PyTorch/CUDA port — the paper's own workloads:
simulate ResNet-50 training and inference on the HT3/HI3 accelerators,
print the Conv/non-Conv and per-phase breakdowns (paper Table VI /
Sec. V), then run the objective-first DSE (paper Table VIII row + the
Sec. VI energy half) with its grid reductions on the card
(``backend="torch-fused"``: the cycles searches through the hand-written
``grid_minmax`` kernel): min-cycles, min-energy and min-EDP allocations,
the cycles-vs-energy Pareto frontier, and the off-lattice refine
front-end.  Runs on the CUDA card; ``--device cpu`` runs the reductions'
plain versions instead (without a card and without it, it raises).  It
prints the lines of ``examples/simulate_accelerator.py``.

  PYTHONPATH=src python examples/torch_simulate_accelerator.py [--device cpu]
"""
import argparse

from repro_torch.core import HI3, HT3, Study, Workload, simulate


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device
    backend = "torch-fused"

    print("== ResNet-50 training on HT3 (64x64 PE array, batch 32) ==")
    rep = simulate(HT3, "resnet50", mode="training")
    e = rep.energy(HT3)
    print(f"  total cycles      : {rep.total_cycles:.3e}")
    print(f"  non-Conv runtime  : {rep.nonconv_fraction('cycles'):.1%}"
          f"  (paper: 59.5%; this model brackets it, see"
          f" benchmarks/table11_training_dse.py)")
    print(f"  non-Conv off-chip : {rep.nonconv_fraction('dram'):.1%}"
          f"  (paper: 56.2%)")
    shares = ", ".join(f"{k} {v:.1%}"
                       for k, v in sorted(rep.phase_shares().items()))
    print(f"  phase shares      : {shares}")
    print(f"  energy            : {e['E_total']:.3f} J,"
          f" P_avg {e['P_avg']:.2f} W, t {e['runtime_s']:.3f} s")

    print("== ResNet-50 inference on HI3 (batch 1) ==")
    rep = simulate(HI3, "resnet50", mode="inference")
    print(f"  non-Conv runtime  : {rep.nonconv_fraction('cycles'):.1%}"
          f"  (paper: 49.3%)")

    print("== DSE: optimal vs worst allocation (2048kB, 2048 bits/cyc) ==")
    study = Study(HI3, backend=backend, device=device)
    inference = Workload("resnet50")            # batch 1, BN-folded
    res = study.search(inference, 2048, 2048)
    grid_best = res.best.cycles
    print(f"  best  {res.best.sizes_kb} kB, bw {res.best.bws}"
          f" -> {res.best.cycles:.3e} cycles")
    print(f"  worst -> {res.worst.cycles:.3e} cycles")
    print(f"  improvement {res.improvement:.1f}x (paper: 18.43x)")

    print("== Objectives: min-energy / min-EDP on the same grid ==")
    res_e = study.search(inference, 2048, 2048, objective="energy")
    res_edp = study.search(inference, 2048, 2048, objective="edp")
    print(f"  min-cycles point  : {res.energy_of():.4f} J,"
          f" {res.power_of():.2f} W")
    print(f"  min-energy point  : {res_e.best_score:.4f} J at"
          f" {res_e.best.cycles / grid_best:.1%} of min-cycles latency"
          f"  (sizes {res_e.best.sizes_kb} kB)")
    print(f"  min-EDP point     : {res_edp.energy_of():.4f} J at"
          f" {res_edp.best.cycles / grid_best:.1%} latency")
    front = res.pareto()
    print(f"  cycles-energy Pareto frontier: {len(front)} points"
          f" (vs {len(res.points)} in the within-15% cycles band)")
    for p in front:
        print(f"    {p.sizes_kb} kB, bw {p.bws}: {p.cycles:.3e} cyc,"
              f" {res.energy_of(p):.4f} J")

    print("== Training-graph DSE on HT3 (same budget) ==")
    training = Workload("resnet50", training=True)   # batch 32, Table I
    res_t = Study(HT3, backend=backend, device=device).search(
        training, 2048, 2048)
    pb = res_t.phase_breakdown()
    print(f"  best  {res_t.best.sizes_kb} kB, bw {res_t.best.bws}"
          f" -> {res_t.best.cycles:.3e} cycles")
    print(f"  at optimum: non-Conv {pb.nonconv_share:.1%},"
          f" backward+updates {pb.bwd_share:.1%}")

    print("== Off-lattice DSE (method='refine', same budget) ==")
    ref = study.search(inference, 2048, 2048, method="refine")
    print(f"  best  {ref.best.sizes_kb} kB, bw {ref.best.bws}"
          f" -> {ref.best.cycles:.3e} cycles"
          f" ({ref.best.cycles / grid_best:.1%} of the power-of-two optimum"
          f" at {ref.refine.eval_saving:.0f}x fewer evaluations)")
    pb = ref.phase_breakdown()          # works off-lattice too
    print(f"  at refined optimum: non-Conv {pb.nonconv_share:.1%}")
    ref_e = study.search(inference, 2048, 2048, objective="energy",
                         method="refine")
    print(f"  min-energy refine : {ref_e.best_score:.4f} J"
          f" ({ref_e.best_score / res_e.best_score:.1%} of the"
          f" power-of-two energy optimum)")


if __name__ == "__main__":
    main()
