"""NLFFC (02), team02 "Virtual_Reality" (counterpart of ``ntire2022_esr_tpu/models/nlffc.py``;
reference models/team02_nlffc/NLFFC.py:10-57).

The image is upsampled x4 (bicubic) first; a 1x1 conv widens it to 64
channels, then nine FFCU blocks, each followed by a 1x1, with two long
residuals, and a final ReLU. An FFCU block splits its channels into a
local and a global half:

- a 3x3 conv + LeakyReLU(0.2) on each half, summed (under every tier but
  parity one block-diagonal conv over both halves, as the JAX package's
  ``fuse_parallel_branches("nlffc")`` does under AUTO);
- the local half through a global-context gate (two softmaxes, each
  jointly over both spatial axes) and a 1x1;
- the global half through ``ops.spectral.spectral_tx`` (an FFT over the
  height axis, as DFT products).

The registry runs it tiled (tile 256, 2 tiles a call): a 256 tile is a
1024x1024 body. On stock ops and the DFT products; no custom kernel.
"""

from __future__ import annotations

import torch
from torch import nn

from ntire2022_esr_tpu_torch import config, ops
from ntire2022_esr_tpu_torch.models.blocks import Layer
from ntire2022_esr_tpu_torch.ops.spectral import spectral_tx

SLOPE = 0.2


class GlobContext(nn.Module):
    """JAX ``_global_context`` (team02_nlffc/basicblock.py:39-71): the torch
    graph flattens to (n, h*w, c) for its softmaxes; a softmax jointly over
    dims (2, 3) is the same function."""

    def __init__(self):
        super().__init__()
        for name in ("conv1", "conv2", "conv3", "conv4"):
            self.add_module(name, Layer())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = ops.softmax(ops.relu(ops.conv(self.conv1, x, padding=0)), dim=(2, 3))
        b2 = ops.leaky_relu(ops.conv(self.conv2, x * b1, padding=0), SLOPE)
        b2 = ops.leaky_relu(ops.conv(self.conv3, b2), SLOPE)
        b2 = ops.softmax(ops.conv(self.conv4, b2), dim=(2, 3))
        return b2 * x


class FFCU(nn.Module):
    """JAX ``_ffcu``: the local/global split unit. When its weights are
    loaded it derives the block-diagonal weight ``w_pair`` and bias
    ``b_pair`` of its 3x3 pair once, as buffers outside the state dict, as
    ``models.blocks.Nearest2Layer`` does; loading another weight set makes
    new ones. Under w8 ``w_pair`` is the int8 weights merged the same way,
    beside their scales merged into ``w_pair_scale`` (0 off the blocks):
    dequantized at use, each block is its branch's dequantized weight and
    every weight off the blocks is 0 * 0 = 0 in any dtype, so the merged
    conv computes what the JAX package's merge of the dequantized weights
    does. The biases stay f32."""

    def __init__(self):
        super().__init__()
        for name in ("conv0", "conv1", "conv2"):
            self.add_module(name, Layer())
        self.GlobContext = GlobContext()
        self.SpT = nn.Module()
        self.SpT.conv = Layer()
        self.register_buffer("w_pair", None, persistent=False)
        self.register_buffer("w_pair_scale", None, persistent=False)
        self.register_buffer("b_pair", None, persistent=False)
        self.register_load_state_dict_post_hook(FFCU._merge_pair)

    @staticmethod
    def _merge_pair(module: "FFCU", incompatible_keys) -> None:
        # after the children have loaded theirs
        c1, c2 = module.conv1, module.conv2
        with torch.no_grad():
            module.w_pair = ops.block_diag_weights([c1.weight, c2.weight])
            scales = [ops.nn.weight_scale(c) for c in (c1, c2)]
            module.w_pair_scale = None if scales[0] is None else ops.block_diag_weights(scales)
            module.b_pair = ops.concat_biases(
                [(c1.bias, int(c1.weight.shape[0])), (c2.bias, int(c2.weight.shape[0]))],
                torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[1]
        loc = c - c // 2
        xl, xg = x[:, :loc], x[:, loc:]
        if config.mode() != "parity":
            # the 3x3 pair as one block-diagonal conv over the unsplit input:
            # the weights off the blocks are zero, so only the order of the
            # f32 sums can differ
            w = ops.nn.dequant(self.w_pair, self.w_pair_scale)
            both = ops.leaky_relu(ops.conv2d(x, w, self.b_pair), SLOPE)
            c00, c10 = both[:, :loc], both[:, loc:]
        else:
            c00 = ops.leaky_relu(ops.conv(self.conv1, xl), SLOPE)
            c10 = ops.leaky_relu(ops.conv(self.conv2, xg), SLOPE)
        c01 = ops.conv(self.conv0, self.GlobContext(xl), padding=0)
        c11 = spectral_tx(self.SpT, xg)
        return ops.cat([c00 + c10, c01 + c11])


class NLFFC(nn.Module):
    """JAX ``nlffc_apply``; NHWC in, NHWC out."""

    def __init__(self, upscale: int = 4, n_blocks: int = 9):
        super().__init__()
        self.upscale = upscale
        for i in range(n_blocks + 1):
            self.add_module(f"c{i}", Layer())
        for i in range(1, n_blocks + 1):
            self.add_module(f"b{i}", FFCU())

    def _stage(self, i: int, h: torch.Tensor) -> torch.Tensor:
        return ops.conv(getattr(self, f"c{i}"), getattr(self, f"b{i}")(h), padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = ops.interpolate(ops.from_nhwc(x), scale_factor=self.upscale, mode="bicubic")
        h = ops.conv(self.c0, x, padding=0)
        h1 = self._stage(1, h)
        h2 = self._stage(2, h1)
        h3 = self._stage(3, h2)
        h4 = self._stage(4, h3) + h2
        h5 = self._stage(5, h4)
        h6 = self._stage(6, h5)
        h7 = self._stage(7, h6)
        h8 = self._stage(8, h7) + h4
        return ops.to_nhwc(ops.relu(self._stage(9, h8)))
