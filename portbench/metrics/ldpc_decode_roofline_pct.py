"""Share of its roofline that the LDPC decoder reaches: the least time the
card could take for the decoding work of the traced stretch, over the
device time of the decoder's kernels there.

The work is counted from shapes and from the iterations that the
benchmark's reference decoder needed on the same inputs
(``portbench.reference.ldpc``), whatever implements the decode: 9 float32
operations per edge, z and iteration and 2 per check row and z, and each
input and output byte once.  The least time of a launch is the larger of
its operations over the float32 peak and its bytes over HBM's rate
(``portbench.harness.yardstick``); the stretch's is the sum over its
launches.  The program's decoder kernels, by name and by how a call
launches them (an entry's ``ldpc_kernel``): K1, the fused rate dematch and
decode, once a call over all its TBs, reading the TBs' int8 LLRs; K2, the
decode of dematched buffers, once a call per code group (base graph,
lifting size, circular buffer length), reading the (C, N) int8 buffers.
Each writes the (C, K) bits and the (C,) int32 iteration counts
(``srsran_project_tpu_torch/csrc``)."""

import re

from portbench.harness import yardstick
from portbench.reference import ldpc

KERNELS = re.compile(r"(^|[^A-Za-z0-9_])(decode_dematch_kernel|decode_kernel)\(")


def work(tbs: list, buffer_input: bool) -> tuple:
    """(float32 operations, bytes) of one launch over [(grant, iterations
    needed (C,))]."""
    ops = nbytes = 0.0
    for g, needed in tbs:
        s = g.seg
        ops += ldpc.ldpc_operations(ldpc.decode_plan(s.bg, s.z, g.n_cb), int(needed.sum()))
        nbytes += (s.c * s.n if buffer_input else g.g) + s.c * s.k + 4 * s.c
    return ops, nbytes


def launches(ctx) -> list:
    """(operations, bytes) of every decoder launch of the traced stretch."""
    kernel = getattr(ctx.entry, "ldpc_kernel", None)
    out = []
    for unit, step in ctx.traced:
        tbs = ctx.entry.decoded_tbs(unit, step, ctx.reference)
        if kernel == "K1":
            out.append(work(tbs, buffer_input=False))
        elif kernel == "K2":
            groups: dict = {}
            for g, needed in tbs:
                groups.setdefault((g.seg.bg, g.seg.z, g.n_cb), []).append((g, needed))
            out += [work(v, buffer_input=True) for v in groups.values()]
    return out


def read(ctx):
    if ctx.trace is None:
        return None
    device_s = sum(s for name, s in ctx.trace.kernels if KERNELS.search(name))
    work_ = launches(ctx)
    if device_s <= 0 or not work_:
        return None
    least_s = sum(yardstick.bound_s(nbytes, ops) for ops, nbytes in work_)
    return 100.0 * least_s / device_s
