"""chain_roofline.protocol: the conv-chain kernel's share of its roofline, in
%.

The least time the window's frames need in the chain (``work.py``: the
chain's operations against the 16-bit tensor peak, or its bytes at the
tier's storage width against HBM, whichever is larger, for every call the
configuration lists) over the device time of the kernels whose names start
with ``conv3x3_chain`` (in the namespace ``esr``) in the replays' spans
(each from its start event to its stop event). None where no such kernel
ran. Moves ``runtime_ms``.
"""

PATTERN = r"^(void )?(esr::)?conv3x3_chain"


def read(r):
    t = r.kernel_s(PATTERN)
    bound = r.bound_s("chain")
    if t <= 0 or bound <= 0:
        return None
    return 100.0 * bound / t
