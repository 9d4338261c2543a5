"""RFDN baseline, the AIM 2020 winner (counterpart of ``ntire2022_esr_tpu/models/rfdn.py``).

``fea_conv`` -> 4 RFDBs -> 1x1 fusion -> ``LR_conv`` + long skip ->
PixelShuffle x4 tail, on stock ops but the x4 upsampler, which runs as the
tail kernel (``blocks.conv_shuffle``). The same graph serves the zoo
entries

- 00 (the baseline), 06 (team06: a copy of it) and 22 (team22, nf 40,
  the reparameterised weights already collapsed in the checkpoint);
- 08 (team08 SFDN): ``residual=False, esa_conv_f=False``;
- 40 (team40, pruned): ``residual=False``;
- 13 (team13): ``dilations=(1, 2, 5)``.

The widths come from the weight cache (``blocks.Layer``).
"""

from __future__ import annotations

from ntire2022_esr_tpu_torch.models import blocks


class RFDN(blocks.RFDNSkeleton):
    """JAX ``rfdn_apply`` with its default block; NHWC in, NHWC out."""

    def __init__(self, *, residual: bool = True, esa_conv_f: bool = True,
                 dilations=(1, 1, 1), num_modules: int = 4, upscale: int = 4):
        super().__init__(lambda: blocks.RFDB(blocks.ESA(conv_f=esa_conv_f), residual=residual,
                                             dilations=dilations),
                         num_modules=num_modules, upscale=upscale)
