"""Readings that the output check's limits are set from, on the card, at
a cell's own sizes: for each seed the program's gaps to the reference
(the lower readings), and for the control seeds the gaps of the control
(the reference computed with its convolution and linear operands rounded
through float8, one precision below the configuration's bfloat16) to
the reference (the upper readings).  Runs every seed in one process.

    python3 portbench/harness/calibrate.py --workload flagship.predict \
        --seeds 1 2 3 --control-seeds 1 2 3 --seconds 2 --out DIR

Writes ``DIR/<workload>.jsonl``, one line per seed and side.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def _numbers(driver, kind, quant=None):
    """(the compared numbers of the program, or of the control where
    ``quant`` is given, against the reference; train steps: (reference,
    side) losses)."""
    from portbench.harness import compare

    if kind == "train":
        ref = driver.reference_steps()
        ref_last = driver.reference_last_step()
        if quant is None:
            side = (driver.set_up_losses, driver.first_grad, driver.change)
            side_last = (driver.last["losses"], None, driver.last["change"])
        else:
            side = driver.reference_steps(quant)
            side_last = driver.reference_last_step(quant)
        return ({**compare.train_numbers(side, ref),
                 **compare.last_step_numbers(side_last[2], ref_last[1:])},
                (ref[0] + [ref_last[0]], side[0] + [side_last[0]]))
    ref = driver.reference_outputs()
    if quant is not None:
        driver.outputs = {
            k: {key: (v.cpu().numpy() if hasattr(v, "cpu") else v)
                for key, v in d.items() if key in ("bbox", "score", "valid")}
            for k, d in driver.reference_outputs(quant).items()}
    if kind == "predict":
        return compare.predict_numbers(driver.outputs, ref), None
    (k, r), = ref.items()
    dets = driver.outputs[k]
    if quant is not None:
        dets = [{"bbox": b, "score": s} for b, s in zip(dets["bbox"],
                                                         dets["score"])]
    return compare.plot_numbers(dets, r), None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", required=True)
    ap.add_argument("--fault", default=None,
                    help="a fault of faults.py planted in the program on "
                         "--fault-seeds")
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    from portbench.harness import plugins
    from portbench.harness.main import cell_spec, load_bench

    bench = load_bench(ROOT)
    _, conf, traffic = cell_spec(bench, ROOT, args.workload)
    control = plugins.architecture(conf, ROOT).fp8
    os.makedirs(args.out, exist_ok=True)
    log = open(os.path.join(args.out, args.workload + ".jsonl"), "a")
    for seed in args.seeds:
        t0 = time.perf_counter()
        sides = [("program", None, False)]
        if seed in args.fault_seeds:
            sides.append(("fault:" + args.fault, None, True))
        if seed in args.control_seeds:
            sides.append(("control", control, False))
        for side, quant, planted in sides:
            _side(args, conf, traffic, seed, side, quant, planted, log)
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
    return 0


def _side(args, conf, traffic, seed, side, quant, planted, log):
    import contextlib

    import torch

    from portbench.harness import cells, faults

    plant = (faults.FAULTS[args.fault]() if planted
             else contextlib.nullcontext())
    with plant:
        driver = cells.make(traffic["kind"], conf, traffic, seed, ROOT)
        driver.setup()
        driver.window(args.seconds)
        driver.free()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    nums, losses = _numbers(driver, traffic["kind"], quant)
    line = {"seed": seed, "side": side, "numbers": nums,
            "check_s": time.perf_counter() - t1,
            "ref_peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    if losses is not None:
        line["ref_losses"], line["losses"] = losses
    print(json.dumps(line), flush=True)
    log.write(json.dumps(line) + "\n")
    log.flush()
    del driver
    torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
