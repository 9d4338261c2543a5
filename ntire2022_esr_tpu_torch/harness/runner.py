"""Per-model evaluation loop (counterpart of ``ntire2022_esr_tpu/harness/runner.py``;
reference test_demo.run, test_demo.py:394-477).

- The forward alone is timed, with a CUDA event pair as the reference
  does (on the CPU, with the host clock).
- On a CUDA device the timed forward is one CUDA graph, as the JAX
  runner times one compiled executable: ``graphs.GraphedForward`` captures
  the whole forward (a tiled or x8 one included) once per input shape,
  after a warm-up that builds the kernels and packs the weights, and the
  events bracket ``graph.replay()`` alone. Without it the events would
  count the gaps in which the device waits for Python to dispatch the
  next op. One graph is alive at a time, so ``{mode}_memory`` does not
  grow with the number of shapes. On the CPU the forward runs eagerly,
  after one untimed forward per shape.
- A background thread decodes the next image into pinned host memory
  while the current one is scored and saved. It waits on a semaphore that
  the main thread releases after the timed forward, so no decode, and no
  ``cudaHostAlloc`` of ``pin_memory``, runs during a warm-up, a capture
  (where another thread's allocation of pinned memory would invalidate
  it) or a timed forward. The main thread copies the image to the device
  with ``non_blocking=True``.
- ``{mode}_memory`` is ``torch.cuda.max_memory_allocated()`` in MB since
  the run started, the reference's own measure (0.0 on the CPU).
- With a mesh (``run(spatial_mesh=)``, ``run_batched(mesh=)``;
  ``parallel/``) each entry's forward is its own graph, captured for its
  shard's shape. The sharded forward's ``prepare`` places every shard (a
  batch chunk, or a slab with its halo rows) in its entry's static input,
  capturing a graph where the shape is new, before the timer starts, as
  the one-device path loads its static input; the timed window is every
  entry's replay and the gather of the outputs on the first device.
  ``{mode}_memory`` is then the largest peak of the run's devices.
"""

from __future__ import annotations

import logging
import os
import threading
from queue import Queue
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ntire2022_esr_tpu_torch.harness import data as data_mod
from ntire2022_esr_tpu_torch.harness import graphs, profiling, tiling
from ntire2022_esr_tpu_torch.harness.serving import u8_forward
from ntire2022_esr_tpu_torch.parallel import sharded_batch_apply
from ntire2022_esr_tpu_torch.parallel.spatial import SpatialShardUnavailable, make_spatial_apply
from ntire2022_esr_tpu_torch.utils import image as img_util
from ntire2022_esr_tpu_torch.utils import metrics


class _Eager:
    """The ``prepare``/``replay`` pair of a forward run eagerly (on the CPU)."""

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor]):
        self._fn = fn

    def prepare(self, x: torch.Tensor) -> None:
        self._x = x

    def replay(self) -> torch.Tensor:
        return self._fn(self._x)


def _prefetch(pairs, data_range: float, pin: bool, q: Queue, go: threading.Semaphore) -> None:
    # A decode failure must reach the consumer: without it the eval loop
    # would block on q.get() forever, so the exception itself is sent.
    try:
        for lr_path, hr_path in pairs:
            go.acquire()  # released once the previous image's forward is timed
            lr = img_util.imread_uint(lr_path, n_channels=3)
            x = torch.from_numpy(img_util.uint2nhwc(lr, data_range))
            q.put((lr_path, hr_path, x.pin_memory() if pin else x))
    except BaseException as exc:  # noqa: BLE001 - raised again by the main thread
        q.put(exc)
    else:
        q.put(None)


def _host(t: torch.Tensor) -> np.ndarray:
    """A device result as a host array (bf16 as f32: numpy has no bf16)."""
    t = t.cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _start(model: nn.Module, mesh=None) -> Tuple[torch.device, List[torch.device]]:
    """The model's device and every device of the run (a mesh's too), each
    with its peak-memory counter reset."""
    device = next(model.parameters()).device
    devices = list(dict.fromkeys([device] + (mesh.distinct if mesh is not None else [])))
    for d in devices:
        if d.type == "cuda":
            torch.cuda.reset_peak_memory_stats(d)
    return device, devices


def _memory_mb(devices: List[torch.device], logger: logging.Logger) -> float:
    """The largest peak over the run's CUDA devices, in MB."""
    cuda = [d for d in devices if d.type == "cuda"]
    if cuda:
        return max(torch.cuda.max_memory_allocated(d) for d in cuda) / 1024**2
    logger.info("Max Memory unavailable: peak memory is read from CUDA and this run is on the CPU")
    return 0.0


def _log_memory(logger: logging.Logger, mb: float, devices: List[torch.device]) -> None:
    over = f" (the largest peak of {len(devices)} devices)" if len(devices) > 1 else ""
    logger.info("{:>16s} : {:<.3f} [M]{}".format("Max Memory", mb, over))


def _finish(results: Dict, mode: str, ssim: bool) -> None:
    results[f"{mode}_ave_runtime"] = sum(results[f"{mode}_runtime"]) / len(results[f"{mode}_runtime"])
    results[f"{mode}_ave_psnr"] = sum(results[f"{mode}_psnr"]) / len(results[f"{mode}_psnr"])
    if ssim:
        results[f"{mode}_ave_ssim"] = sum(results[f"{mode}_ssim"]) / len(results[f"{mode}_ssim"])


def run(
    model: nn.Module,
    model_name: str,
    data_range: float,
    tile: Optional[int],
    logger: logging.Logger,
    args,
    mode: str = "test",
    pairs: Optional[List[Tuple[str, str]]] = None,
    spatial_mesh=None,
    spatial_overlap: int = 32,
    max_tiles_per_call: int = 16,
) -> Dict:
    """Evaluate ``model`` (NHWC -> NHWC) one image at a time; returns the
    per-image and average runtime [ms], PSNR (and SSIM with ``args.ssim``)
    and the peak memory [MB] under ``{mode}_*`` keys.

    ``spatial_mesh`` H-shards each whole image over a mesh
    (``parallel/spatial.py``; exact where ``spatial_overlap`` covers the
    receptive field). An image too small to shard runs the one-device
    forward on the model's device, logged once per shape; any other error
    of the sharded forward propagates. A sharded forward is timed from a
    common synchronised start to the last device's end
    (``profiling.MeshTimer``): the replays and the gather of the slabs'
    outputs, after ``prepare`` has placed the slabs and their halos."""
    sf = 4
    border = sf
    ssim = getattr(args, "ssim", False)
    results: Dict = {f"{mode}_runtime": [], f"{mode}_psnr": []}
    if ssim:
        results[f"{mode}_ssim"] = []

    if pairs is None:
        pairs = data_mod.select_dataset(args.data_dir, mode)
    save_path = os.path.join(args.save_dir, model_name, "test" if mode == "test" else "valid")
    img_util.mkdir(save_path)

    spatial_mesh = spatial_mesh if tile is None else None
    device, devices = _start(model, spatial_mesh)
    timer = profiling.Timer(device)

    def forward(x):
        return tiling.forward(model, x, tile, max_tiles_per_call=max_tiles_per_call)

    cuda = device.type == "cuda"
    single = graphs.GraphedForward(forward, device) if cuda else _Eager(forward)

    spatial = None
    if spatial_mesh is not None:
        spatial = make_spatial_apply(model, spatial_mesh, overlap=spatial_overlap, graphed=cuda)
        mesh_timer = profiling.MeshTimer(devices)
    unshardable: set = set()

    def sharded(shape) -> bool:
        """Whether the image takes the sharded forward: only the explicit
        cannot-shard-this-shape condition falls back."""
        if spatial is None:
            return False
        try:
            spatial.plan(shape)
            return True
        except SpatialShardUnavailable as exc:
            if shape not in unshardable:
                unshardable.add(shape)
                logger.info(f"spatial sharding unavailable for shape {tuple(shape)} "
                            f"({exc}); using single-device forward")
            return False

    q: Queue = Queue()
    go = threading.Semaphore(1)
    threading.Thread(target=_prefetch, args=(pairs, data_range, cuda, q, go),
                     daemon=True).start()
    warmed_shapes: set = set()

    with torch.inference_mode():
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            lr_path, hr_path, host_x = item
            img_name, ext = os.path.splitext(os.path.basename(hr_path))
            x = host_x.to(device, non_blocking=True)

            # the first sighting of a shape builds the kernels and packs
            # the weights (on a card prepare does so, and captures each
            # graph); it is not model runtime, and neither is the loading
            # of the static inputs
            step, step_timer = (spatial, mesh_timer) if sharded(x.shape) else (single, timer)
            if not cuda and x.shape not in warmed_shapes:
                step.prepare(x)
                step.replay()
                warmed_shapes.add(x.shape)
            step.prepare(x)
            step_timer.start()
            out = step.replay()
            results[f"{mode}_runtime"].append(step_timer.stop())
            go.release()

            sr_u8 = img_util.nhwc2uint(_host(out), data_range)
            # a graph's static output: it must not outlive its graph into
            # the next shape's capture, where it would add to the peak
            del out

            hr = img_util.imread_uint(hr_path, n_channels=3)
            hr = img_util.modcrop(np.squeeze(hr), sf)

            psnr = metrics.calculate_psnr(sr_u8, hr, border=border)
            results[f"{mode}_psnr"].append(psnr)
            if ssim:
                s = metrics.calculate_ssim(sr_u8, hr, border=border)
                results[f"{mode}_ssim"].append(s)
                logger.info(f"{img_name}{ext} - PSNR: {psnr:.2f} dB; SSIM: {s:.4f}.")
            else:
                logger.info(f"{img_name}{ext} - PSNR: {psnr:.2f} dB")

            img_util.imsave(sr_u8, os.path.join(save_path, img_name[:4] + ext))

    results[f"{mode}_memory"] = _memory_mb(devices, logger)
    _finish(results, mode, ssim)
    _log_memory(logger, results[f"{mode}_memory"], devices)
    logger.info(
        "------> Average runtime of ({}) is : {:.6f} milliseconds".format(
            "test" if mode == "test" else "valid", results[f"{mode}_ave_runtime"]
        )
    )
    return results


def run_batched(
    model: nn.Module,
    model_name: str,
    data_range: float,
    logger: logging.Logger,
    args,
    mode: str = "test",
    pairs: Optional[List[Tuple[str, str]]] = None,
    mesh=None,
    u8_io: bool = False,
    spatial_overlap: int = 32,
) -> Dict:
    """Shape-bucketed batched evaluation (throughput path).

    Images are grouped by exact (H, W) and each bucket runs as one batch;
    the batch's time is attributed evenly to its images. ``u8_io=True``
    moves the uint8 <-> float conversions onto the device
    (``serving.u8_forward``); outputs can then differ from the host conversion
    by round-tie flips only.

    ``mesh`` shards each batch: over a 1-D mesh by images
    (``parallel.sharded_batch_apply``), over a (data, space) mesh by
    images and H-slabs (``parallel.make_spatial_apply`` with
    ``spatial_overlap``). The batch is padded with zero images to a
    multiple of the data axis, and the time is charged per slot, padding
    slots included (they run the same work as real images). A sharded
    batch is timed from a common synchronised start to the last device's
    end (``profiling.MeshTimer``): the replays and the gather of the
    outputs, after ``prepare`` has placed the shards.
    """
    sf = 4
    border = sf
    ssim = getattr(args, "ssim", False)
    results: Dict = {f"{mode}_runtime": [], f"{mode}_psnr": []}
    if ssim:
        results[f"{mode}_ssim"] = []

    if pairs is None:
        pairs = data_mod.select_dataset(args.data_dir, mode)
    save_path = os.path.join(args.save_dir, model_name, "test" if mode == "test" else "valid")
    img_util.mkdir(save_path)

    buckets: Dict[Tuple[int, int], List[Tuple[str, str, np.ndarray]]] = {}
    for lr_path, hr_path in pairs:
        lr = img_util.imread_uint(lr_path, n_channels=3)
        buckets.setdefault(lr.shape[:2], []).append((lr_path, hr_path, lr))

    device, devices = _start(model, mesh)
    cuda = device.type == "cuda"
    fn = (lambda m, b: u8_forward(m, b, data_range)) if u8_io else (lambda m, b: m(b))
    pad_to = 0
    sharded = None
    if mesh is not None and "space" in mesh.shape:
        # batch-parallel groups of H-slab shards: the composed path of
        # --batched --spatial --mesh N; the uint8 conversions are
        # pointwise, so slab-exact
        sharded = make_spatial_apply(model, mesh, overlap=spatial_overlap, axis="space",
                                     batch_axis="data", fn=fn, graphed=cuda)
        pad_to = mesh.shape["data"]
    elif mesh is not None:
        sharded = sharded_batch_apply(model, mesh, fn=fn, graphed=cuda)
        pad_to = mesh.devices.size
    if sharded is not None:
        step, timer = sharded, profiling.MeshTimer(devices)
    else:
        def whole(v):
            return fn(model, v)

        step = graphs.GraphedForward(whole, device) if cuda else _Eager(whole)
        timer = profiling.Timer(device)

    per_image: Dict[str, Tuple[np.ndarray, str]] = {}
    with torch.inference_mode():
        for _, items in sorted(buckets.items()):
            if u8_io:
                batch = np.stack([lr for _, _, lr in items])
            else:
                batch = np.stack([img_util.uint2nhwc(lr, data_range)[0] for _, _, lr in items])
            if pad_to:
                pad = (-len(items)) % pad_to
                if pad:
                    batch = np.concatenate([batch, np.zeros((pad,) + batch.shape[1:], batch.dtype)])
            b = torch.from_numpy(batch)
            if cuda:
                b = b.pin_memory()
            b = b.to(device, non_blocking=True)
            # on the CPU one untimed forward builds the kernels and packs
            # the weights; on a card prepare does so and captures
            if not cuda:
                step.prepare(b)
                step.replay()
            step.prepare(b)
            timer.start()
            out = step.replay()
            elapsed_ms = timer.stop()
            sr = _host(out)
            del out  # as in run: no static output survives into the next capture
            per_img_ms = elapsed_ms / len(batch)
            for k, (lr_path, hr_path, _) in enumerate(items):
                results[f"{mode}_runtime"].append(per_img_ms)
                per_image[hr_path] = (sr[k], lr_path)

    for lr_path, hr_path in pairs:
        sr_arr, _ = per_image[hr_path]
        img_name, ext = os.path.splitext(os.path.basename(hr_path))
        sr_u8 = sr_arr if u8_io else img_util.nhwc2uint(sr_arr, data_range)
        hr = img_util.modcrop(np.squeeze(img_util.imread_uint(hr_path, n_channels=3)), sf)
        psnr = metrics.calculate_psnr(sr_u8, hr, border=border)
        results[f"{mode}_psnr"].append(psnr)
        if ssim:
            results[f"{mode}_ssim"].append(metrics.calculate_ssim(sr_u8, hr, border=border))
        logger.info(f"{img_name}{ext} - PSNR: {psnr:.2f} dB")
        img_util.imsave(sr_u8, os.path.join(save_path, img_name[:4] + ext))

    results[f"{mode}_memory"] = _memory_mb(devices, logger)
    _finish(results, mode, ssim)
    _log_memory(logger, results[f"{mode}_memory"], devices)
    logger.info(
        "------> Average runtime of ({}) is : {:.6f} milliseconds (shape-bucketed)".format(
            "test" if mode == "test" else "valid", results[f"{mode}_ave_runtime"]
        )
    )
    return results
