"""LDPC iterations a codeblock, as the program's decoder counts them: the
sum of the ``iterations`` the program's ``ldpc.decode`` spans carry (the
(C,) counts K1 and K2 return, early stop per codeblock) over the sum of
their ``codeblocks``, over the traced stretch."""

from portbench.harness import spans


def read(ctx):
    t = spans.totals(ctx)
    counts = t["ldpc.decode"].counts if t and "ldpc.decode" in t else {}
    if not counts.get("codeblocks"):
        return None
    return counts["iterations"] / counts["codeblocks"]
