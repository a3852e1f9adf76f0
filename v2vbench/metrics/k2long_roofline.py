"""The least time of K2 long's calls in the traced request (operations at
989 TFLOP/s or bytes at 3.35 TB/s, the larger) over their device time, in %."""


def read(trace):
    return trace.roofline("k2long")
