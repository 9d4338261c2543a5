"""CLI entry point (counterpart of ``ntire2022_esr_tpu/harness/cli.py``; the
reference's ``test_demo.py`` :480-577).

    python -m ntire2022_esr_tpu_torch.harness.cli --data_dir D --save_dir S \
        --model_id N [--include_test] [--ssim] [--mode parity|high|mixed|fast] \
        [--batched [--u8_io]] [--mesh N] [--spatial] [--space S] [--x8] \
        [--device cuda|cpu]

Evaluates zoo models on DIV2K valid (and test), accumulates results.json /
results.txt in the working directory and logs per-image PSNR. A failed
model never stops a sweep. Runs on CUDA unless ``--device`` says otherwise.

``--mesh N`` shards over ``cuda:0 ... cuda:N-1`` (with ``--device cpu``,
over N entries of the CPU): with ``--batched`` the batch, with
``--spatial`` each image's rows. ``--batched --spatial --mesh N`` composes
both on a 2-D (data, space) mesh: N/S batch-parallel groups, each
H-slab sharded S ways (slab-safe models only).
"""

from __future__ import annotations

import argparse
import logging
import os
from pprint import pprint

import torch

from ntire2022_esr_tpu_torch import config
from ntire2022_esr_tpu_torch.harness import data as data_mod
from ntire2022_esr_tpu_torch.harness import registry, results as results_mod, runner, summary
from ntire2022_esr_tpu_torch.harness.ensemble import self_ensemble_x8
from ntire2022_esr_tpu_torch.parallel import data_space_mesh, make_mesh
from ntire2022_esr_tpu_torch.utils import logger as logger_mod


def evaluate_model(model_id: int, args, logger: logging.Logger, device: torch.device):
    model, model_name, data_range, tile = registry.build_model(model_id, device=device)
    logger.info(model_name)

    if getattr(args, "x8", False):
        model = self_ensemble_x8(model)
        model_name = model_name + "_x8"

    spatial = getattr(args, "spatial", False)
    n_mesh = getattr(args, "mesh", 0)
    if spatial and not n_mesh:
        # refuse a configuration that would silently run unsharded
        raise ValueError("--spatial requires --mesh N")
    mesh = None
    if n_mesh:
        # a CUDA run takes cuda:0 ... cuda:N-1 (make_mesh's default); a CPU
        # run lists the CPU N times
        devices = [device] * n_mesh if device.type == "cpu" else None
        if spatial and getattr(args, "batched", False):
            space = getattr(args, "space", 2) or 2
            if n_mesh % space:
                raise ValueError(f"--mesh {n_mesh} must divide by --space {space} "
                                 "for the composed path")
            mesh = data_space_mesh(n_mesh // space, space, devices=devices)
        else:
            mesh = make_mesh(n_mesh, devices=devices)

    def _pairs(mode):
        # tolerate partial datasets (the reference hard-codes 100 ids and
        # crashes on gaps); the runners stay strict on explicit pairs
        sel = data_mod.select_dataset(args.data_dir, mode)
        found = [(lr, hr) for lr, hr in sel if os.path.exists(lr) and os.path.exists(hr)]
        if not found:
            raise FileNotFoundError(
                f"no {mode} LR images under {args.data_dir} (expected e.g. {sel[0][0]})")
        if len(found) < len(sel):
            logger.info(f"{mode}: {len(found)}/{len(sel)} images present")
        return found

    spec = registry.get_spec(model_id)
    batched = getattr(args, "batched", False) and tile is None
    if not spec.slab_safe and mesh is not None and (
            "space" in mesh.shape if batched else spatial):
        # H-slab sharding is exact only for translation-invariant models
        # with a bounded receptive field (ModelSpec.slab_safe): refuse
        # rather than compute wrong pixels near the slab boundaries
        raise ValueError(
            f"model {model_id} ({model_name}) is not slab-decomposable (pooling-grid / "
            "global ops); use --batched --mesh N instead")
    modes = ["valid", "test"] if args.include_test else ["valid"]
    entry: dict = {}
    for mode in modes:
        if batched:
            entry.update(runner.run_batched(model, model_name, data_range, logger, args,
                                            mode=mode, mesh=mesh,
                                            u8_io=getattr(args, "u8_io", False),
                                            spatial_overlap=spec.halo, pairs=_pairs(mode)))
        else:
            entry.update(runner.run(model, model_name, data_range, tile, logger, args,
                                    mode=mode, spatial_mesh=mesh if spatial else None,
                                    spatial_overlap=spec.halo,
                                    max_tiles_per_call=spec.max_tiles_per_call,
                                    pairs=_pairs(mode)))

    if any(entry.get(key) == 0.0 for key in ("valid_memory", "test_memory")):
        logger.info("Mem column unavailable: no CUDA device in this run")

    comp = summary.model_complexity(
        model, (256, 256),
        params_convention=getattr(args, "params_convention", "deploy"),
        model_name=model_name)
    logger.info("{:>16s} : {:<.4f} [M]".format("#Activations", comp["activations"]))
    logger.info("{:>16s} : {:<d}".format("#Conv2d", comp["num_conv"]))
    logger.info("{:>16s} : {:<.4f} [G]".format("FLOPs", comp["flops"]))
    logger.info("{:>16s} : {:<.4f} [M]".format("#Params", comp["num_parameters"]))
    entry.update(comp)
    return model_name, entry


def main(argv=None):
    parser = argparse.ArgumentParser("NTIRE2022-EfficientSR-H100")
    parser.add_argument("--data_dir", required=True, type=str)
    parser.add_argument("--save_dir", default="./sr_results", type=str)
    parser.add_argument("--model_id", default=0, type=int, nargs="+")
    parser.add_argument("--include_test", action="store_true", help="Inference on the DIV2K test set")
    parser.add_argument("--ssim", action="store_true", help="Calculate SSIM")
    parser.add_argument("--mode", default="parity", choices=["parity", "high", "mixed", "fast"],
                        help="numerics: parity, high and mixed = f32 on the card (TF32 off); "
                             "fast = bf16 activations and weights")
    parser.add_argument("--batched", action="store_true",
                        help="shape-bucketed batched evaluation (throughput path)")
    parser.add_argument("--u8_io", action="store_true",
                        help="with --batched: uint8 device boundary (4x smaller "
                             "H2D/D2H; output may differ by round-tie flips)")
    parser.add_argument("--mesh", default=0, type=int, metavar="N",
                        help="shard over N devices (cuda:0..N-1; N times the CPU with "
                             "--device cpu): with --batched the batch, with --spatial "
                             "each image's rows")
    parser.add_argument("--spatial", action="store_true",
                        help="H-slab spatial sharding with halo exchange (needs --mesh N); "
                             "with --batched: composed 2-D (data, space) mesh")
    parser.add_argument("--space", default=2, type=int, metavar="S",
                        help="space-axis width of the composed --batched --spatial "
                             "mesh (mesh = (N/S, S); default 2)")
    parser.add_argument("--x8", action="store_true",
                        help="x8 dihedral self-ensemble inference")
    parser.add_argument("--params_convention", default="deploy",
                        choices=["deploy", "reference"],
                        help="#Params counting: 'deploy' = the folded params "
                             "actually stored; 'reference' = add back the "
                             "weight-norm g vectors the porter folds (matches "
                             "the published table for models 23/36/42)")
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device to run on (default cuda; cpu runs the plain "
                             "PyTorch versions of the kernels)")
    args = parser.parse_args(argv)
    pprint(args)

    config.set_mode(args.mode)
    device = config.resolve_device(args.device)
    logger_mod.logger_info("NTIRE2022-EfficientSR", log_path="NTIRE2022-EfficientSR.log")
    logger = logging.getLogger("NTIRE2022-EfficientSR")

    json_dir = os.path.join(os.getcwd(), "results.json")
    results = results_mod.load_results(json_dir)

    ids = args.model_id if isinstance(args.model_id, list) else [args.model_id]
    for model_id in ids:
        try:
            model_name, entry = evaluate_model(model_id, args, logger, device)
            results[model_name] = entry
            results_mod.save_results(json_dir, results)
        except Exception:
            logger.exception(f"model {model_id} failed; continuing sweep")

    results_mod.write_table(os.path.join(os.getcwd(), "results.txt"), results, args.include_test)


if __name__ == "__main__":
    main()
