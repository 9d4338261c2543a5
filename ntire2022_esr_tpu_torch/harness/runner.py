"""Per-model evaluation loop (counterpart of ``ntire2022_esr_tpu/harness/runner.py``;
reference test_demo.run, test_demo.py:394-477).

- The forward alone is timed, with a CUDA event pair as the reference
  does (on the CPU, with the host clock).
- On a CUDA device the timed forward is one CUDA graph, as the JAX
  runner times one compiled executable: :class:`GraphedForward` captures
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

Spatial and mesh sharding are not ported yet (ROADMAP §1 item 7); the
CLI refuses their flags.
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
from ntire2022_esr_tpu_torch.harness import profiling, tiling
from ntire2022_esr_tpu_torch.harness.serving import u8_forward
from ntire2022_esr_tpu_torch.utils import image as img_util
from ntire2022_esr_tpu_torch.utils import metrics


# Graphs captured and replayed by GraphedForward in this process. A
# kernel wrapper counts its launches when it is called, so under a graph
# its counter moves at capture only; a replay launches the captured work.
captures = 0
replays = 0

# One side stream per device for every warm-up and capture: cuBLAS keeps a
# workspace (32 MiB on this card) for each stream that has run a matmul,
# for the life of the process, so a new stream per capture would add one
# to the peak memory with every input shape.
_capture_streams: Dict[int, torch.cuda.Stream] = {}


def _capture_stream() -> torch.cuda.Stream:
    dev = torch.cuda.current_device()
    if dev not in _capture_streams:
        _capture_streams[dev] = torch.cuda.Stream()
    return _capture_streams[dev]


class GraphedForward:
    """``fn`` (tensor -> tensor) on a CUDA device, replayed as a CUDA graph
    captured for the shape and dtype of its last input.

    :meth:`prepare` copies an input into the graph's static input buffer,
    after capturing a graph for it if its shape or dtype is new: the
    previous graph, its static buffers and its memory pool are dropped
    first, then ``fn`` runs once on the device's side stream (where the
    kernels are built and their weights packed, the resize matrices cached
    and the cuDNN and cuBLAS workspaces allocated, none of which may happen
    during a capture) and is captured on that stream. :meth:`replay` launches the graph and returns
    its static output, which the next replay overwrites: copy it out first.
    Everything runs under ``torch.cuda.device(device)``.
    """

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor], device: torch.device):
        self._fn = fn
        self._device = torch.device(device)
        self._key: Optional[Tuple] = None
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._in: Optional[torch.Tensor] = None
        self._out: Optional[torch.Tensor] = None

    def prepare(self, x: torch.Tensor) -> None:
        """Load ``x`` into the static input, capturing a graph for it first
        if the live graph was captured for another shape or dtype."""
        global captures
        key = (tuple(x.shape), x.stride(), x.dtype)
        with torch.cuda.device(self._device):
            if key != self._key:
                self._key = self._graph = self._in = self._out = None
                static_in = x.clone()
                side = _capture_stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    self._fn(static_in)
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph, stream=side):
                        out = self._fn(static_in)
                torch.cuda.current_stream().wait_stream(side)
                self._key, self._graph, self._in, self._out = key, graph, static_in, out
                captures += 1
            else:
                self._in.copy_(x)

    def replay(self) -> torch.Tensor:
        global replays
        with torch.cuda.device(self._device):
            self._graph.replay()
        replays += 1
        return self._out


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


def _start(model: nn.Module) -> Tuple[torch.device, profiling.Timer]:
    device = next(model.parameters()).device
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    return device, profiling.Timer(device)


def _memory_mb(device: torch.device, logger: logging.Logger) -> float:
    if device.type == "cuda":
        return torch.cuda.max_memory_allocated(device) / 1024**2
    logger.info("Max Memory unavailable: peak memory is read from CUDA and this run is on the CPU")
    return 0.0


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
    max_tiles_per_call: int = 16,
) -> Dict:
    """Evaluate ``model`` (NHWC -> NHWC) one image at a time; returns the
    per-image and average runtime [ms], PSNR (and SSIM with ``args.ssim``)
    and the peak memory [MB] under ``{mode}_*`` keys."""
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

    device, timer = _start(model)

    def forward(x):
        return tiling.forward(model, x, tile, max_tiles_per_call=max_tiles_per_call)

    graphed = GraphedForward(forward, device) if device.type == "cuda" else None

    q: Queue = Queue()
    go = threading.Semaphore(1)
    threading.Thread(target=_prefetch, args=(pairs, data_range, device.type == "cuda", q, go),
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
            # the weights (and on a card captures the graph); it is not
            # model runtime
            if graphed is not None:
                graphed.prepare(x)
            elif x.shape not in warmed_shapes:
                forward(x)
                warmed_shapes.add(x.shape)
            timer.start()
            out = graphed.replay() if graphed is not None else forward(x)
            results[f"{mode}_runtime"].append(timer.stop())
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

    results[f"{mode}_memory"] = _memory_mb(device, logger)
    _finish(results, mode, ssim)
    logger.info("{:>16s} : {:<.3f} [M]".format("Max Memory", results[f"{mode}_memory"]))
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
    u8_io: bool = False,
) -> Dict:
    """Shape-bucketed batched evaluation (throughput path).

    Images are grouped by exact (H, W) and each bucket runs as one batch;
    the batch's time is attributed evenly to its images. ``u8_io=True``
    moves the uint8 <-> float conversions onto the device
    (``serving.u8_forward``); outputs can then differ from the host conversion
    by round-tie flips only.
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

    device, timer = _start(model)

    def device_fn(b):
        return u8_forward(model, b, data_range) if u8_io else model(b)

    graphed = GraphedForward(device_fn, device) if device.type == "cuda" else None

    per_image: Dict[str, Tuple[np.ndarray, str]] = {}
    with torch.inference_mode():
        for _, items in sorted(buckets.items()):
            if u8_io:
                batch = np.stack([lr for _, _, lr in items])
            else:
                batch = np.stack([img_util.uint2nhwc(lr, data_range)[0] for _, _, lr in items])
            b = torch.from_numpy(batch)
            if device.type == "cuda":
                b = b.pin_memory()
            b = b.to(device, non_blocking=True)
            # builds, packs (and on a card captures) outside the timing
            if graphed is not None:
                graphed.prepare(b)
            else:
                device_fn(b)
            timer.start()
            out = graphed.replay() if graphed is not None else device_fn(b)
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

    results[f"{mode}_memory"] = _memory_mb(device, logger)
    _finish(results, mode, ssim)
    logger.info(
        "------> Average runtime of ({}) is : {:.6f} milliseconds (shape-bucketed)".format(
            "test" if mode == "test" else "valid", results[f"{mode}_ave_runtime"]
        )
    )
    return results
