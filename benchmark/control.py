"""The control of a cell's correctness check, on the card.

    python3 benchmark/control.py --workload ch103.serve --seeds 1 2 3

For each seed it writes the cell's pool of inputs as a run would, and puts
the plain reference in the program's place, computed in the precision
below the one the configuration states (``CONTROL``): for ``f32``, float32
with TF32 matmuls (every input of the pruning's matmuls rounded to TF32,
so the control does not hang on which kernel the library picks), the
precision below float32 with TF32 off; for ``f64``, float32 with TF32
off.
Job by job, once over the pool, it writes the output TSVs the program
would write: the copied columns, the gamma rates, the log-likelihood and
log weight, and an annotation drawn from its own posterior.  The
harness's collector and comparison then judge them as they judge a run
(``--rows`` rows in all, about as many as a run holds against the
reference), and it prints each number beside the cell's limit.  The
control has to come out not correct.  The program is not run.
"""

import argparse
import math
import os
import shutil
import sys
import tempfile
from typing import Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

from benchmark import check, drivers, harness  # noqa: E402
from benchmark.reference import annotation  # noqa: E402
from benchmark.reference.newick import strip_comments  # noqa: E402

# The control's precision for each a configuration may state: (the torch
# dtype's name, whether the pruning's matmul inputs are rounded to TF32).
CONTROL = {"f32": ("float32", True), "f64": ("float32", False)}


def write_outputs(model, out: check.Output, num_rates: int, block: int,
                  generator) -> None:
    """The output TSV the program would write for one family, from
    ``model`` in the program's place."""
    rows = check.read_tsv(out.trees_path)[1]
    cols = annotation.columns(model.heavy)
    lines = ["\t".join(check.expected_header(num_rates, model.heavy))]
    for lo in range(0, len(rows), block):
        part = rows[lo:lo + block]
        b, rates = check.reference_inputs(model, part, num_rates)
        emis = model.emissions(model.site_log_likelihoods(b))
        messages = model.forward(emis)
        ll = model.log_likelihood(emis, messages).double().cpu().numpy()
        paths = model.sample_paths(messages, generator)
        for i, src in enumerate(part):
            ann = annotation.columns_of_path(model, paths[i])
            lines.append("\t".join(
                src[:14] + [strip_comments(src[14])]
                + [repr(float(r)) for r in rates[i]]
                + [repr(float(ll[i])), repr(float(ll[i]) - float(src[1]))]
                + [ann[c] for c in cols]))
        del emis, messages
    with open(out.out_path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def control(cell, seed: int, rows: int, device: str = "cuda",
            dtype=None, tf32: Optional[bool] = None) -> check.Verdict:
    """The verdict of the comparison on the control's outputs of one
    seed.  ``dtype`` and ``tf32`` name the control's precision, by default
    ``CONTROL``'s for the configuration's: with ``tf32`` its pruning rounds
    every matmul input to TF32 (and the card may use TF32 kernels too).
    The tests also run it in float64 without TF32 on the CPU, as a sound
    run."""
    import torch

    from benchmark.reference import model
    from benchmark.reference.model import FamilyModel

    config, traffic = cell.config, cell.traffic
    name, stated_tf32 = CONTROL[config["precision"]]
    dtype = getattr(torch, name) if dtype is None else dtype
    tf32 = stated_tf32 if tf32 is None else tf32
    workdir = tempfile.mkdtemp(prefix="linearham-control-")
    driver = None
    matmul = torch.backends.cuda.matmul.allow_tf32
    try:
        pool = drivers.make_pool(workdir, config, traffic, seed)
        driver = drivers.Driver(workdir, config, traffic, pool, seed,
                                device, stages=False)
        per_item = 1 if traffic["entry"] == "repertoire" \
            else len(pool[0].families)
        n_jobs = len(pool) * per_item
        n_outputs = sum(len(item.families) for item in pool)
        heavy = config["locus"] == "igh"
        collector = check.Collector(
            config["num_rates"], heavy,
            np.random.default_rng([seed % (1 << 64), 0x636b]),
            math.ceil(rows / n_outputs))
        generator = torch.Generator(device=device)
        generator.manual_seed(seed % (1 << 63))
        models, gene_maps = {}, {}
        torch.backends.cuda.matmul.allow_tf32 = tf32
        for k in range(n_jobs):
            outdir = os.path.join(workdir, "out", f"job{k}")
            os.makedirs(outdir, exist_ok=True)
            item, planned = driver.plan(k, outdir)
            for f, out in planned:
                if f.yaml_path not in models:
                    models[f.yaml_path] = FamilyModel.build(
                        f.yaml_path, 0, item.gene_dir, device, dtype,
                        gene_maps)
                    if tf32:
                        models[f.yaml_path].matmul_input = model.tf32
                write_outputs(models[f.yaml_path], out, config["num_rates"],
                              traffic["reference_block"], generator)
            collector.take(k, [o for _, o in planned])
        models.clear()
        torch.backends.cuda.matmul.allow_tf32 = matmul
        return check.compare(collector, device, traffic["reference_block"])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        if driver is not None:
            driver.close()
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--rows", type=int, default=320,
                   help="rows held against the reference, in all")
    args = p.parse_args(argv)
    cell = harness.find_cell(args.workload)
    for seed in args.seeds:
        v = control(cell, seed, args.rows)
        numbers = {"loglik_rel_gap": v.loglik_rel_gap,
                   "bad_rows": v.bad_rows}
        correct = all(numbers[k] <= cell.limits[k] for k in numbers)
        print(f"control {args.workload} seed {seed}: " + ", ".join(
            f"{k} {numbers[k]!r} limit {cell.limits[k]!r}" for k in numbers)
            + f"; {v.rows_sampled} rows, widest gap {v.loglik_abs_gap!r} "
            f"nats; correct {str(correct).lower()}", flush=True)
        for why in v.reasons:
            print(f"  bad row: {why}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
