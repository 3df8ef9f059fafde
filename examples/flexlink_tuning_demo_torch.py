"""The paper's mechanism end to end on the PyTorch port's control plane:
Algorithm-1 convergence trace (Stage 1) followed by runtime adaptation
(Stage 2) when the message size shifts — reproducing the Figure 5
behaviour, plus the predicted Table-2 headline.

Port of ``examples/flexlink_tuning_demo.py``, line for line: the same
seeded H800 timing model, the same printed lines.  It touches no device:
every GB/s and share here is the H800 timing model's, not a measurement.

Run:  PYTHONPATH=src python examples/flexlink_tuning_demo_torch.py
"""

from repro_torch.core.balancer import LoadBalancer
from repro_torch.core.communicator import (CommConfig, FlexCommunicator,
                                           bucket_for)
from repro_torch.core.simulator import MiB, PathTimingModel
from repro_torch.core.topology import Collective
from repro_torch.core.tuner import initial_tune


def main() -> None:
    model = PathTimingModel("h800", noise=0.02, seed=0)
    op, n, payload = Collective.ALL_GATHER, 8, 256 * MiB

    print("== Stage 1: initial coarse-grained tuning (Algorithm 1) ==")
    res = initial_tune(["nvlink", "pcie", "rdma"], "nvlink",
                       lambda fr: model.measure(op, n, payload, fr))
    for t in res.trace[:8]:
        print(f"  iter {t.iteration:2d}  shares={t.shares}  "
              f"imbalance={t.imbalance:.2f}  step={t.step}  moved={t.moved}")
    print(f"  ... converged in {res.iterations} iters -> {res.shares}")

    nccl = model.nccl_baseline_GBps(op, n, payload)
    flex = model.algbw_GBps(op, n, payload, res.fractions())
    print(f"  predicted: NCCL {nccl:.1f} GB/s -> FlexLink {flex:.1f} GB/s "
          f"(+{(flex/nccl-1)*100:.0f}%)")

    print("== Stage 2: runtime fine-grained adjustment (message size "
          "shifts) ==")
    bal = LoadBalancer(res.shares, "nvlink")
    for phase, mib in (("256MB", 256), ("8MB", 8)):
        for _ in range(200):
            bal.observe(model.measure(op, n, mib * MiB, bal.fractions()))
        print(f"  after 200 calls at {phase}: shares={bal.shares} "
              f"({len(bal.adjustments)} adjustments so far)")
    print("  -> secondary shares shrink for latency-bound small messages, "
          "exactly the paper's Fig. 5 adaptation")

    print("== Control plane: the communicator's own Stage-2 trajectory ==")
    # The same mechanism through the FlexCommunicator control plane
    # (SlotController per size bucket): hammer a small bucket and read the
    # last adjustments straight out of report() — source, target, gap,
    # call.  No mesh: a control-plane-only communicator, as the
    # reference's is outside shard_map.
    comm = FlexCommunicator("x", 8, CommConfig(profile="h800",
                                               measurement_noise=0.02))
    big = comm.tune(Collective.ALL_GATHER, 256 * MiB)  # Stage 1, big bucket
    # message size shifts at runtime: seed the small bucket's balancer
    # with the big bucket's converged split (the Fig-5 scenario), then let
    # Stage 2 walk it back using per-call timings
    small = comm.slot(Collective.ALL_GATHER, bucket_for(8 * MiB))
    small.balancer.shares = dict(big.shares)
    for _ in range(300):
        comm.record_call(Collective.ALL_GATHER, 8 * MiB)
    rep = comm.report()
    print(f"  timing source: {rep['timing_source']}")
    for slot, blk in sorted(rep.items()):
        if not isinstance(blk, dict) or "stage2_history" not in blk:
            continue
        print(f"  {slot}: stage1={blk['stage1_shares']} "
              f"-> now={blk['current_shares']} "
              f"({blk['stage2_adjustments']} adjustments, "
              f"warm={blk['warm']})")
        for a in blk["stage2_history"][-4:]:
            print(f"      call {a['call']:4d}  {a['source']} -> "
                  f"{a['target']}  moved={a['moved']}  gap={a['gap']:.2f}"
                  f"  [{a['kind']}]")


if __name__ == "__main__":
    main()
