"""The least time of KR's calls in the traced request (bytes at 3.35 TB/s:
x read once, the output written once) over their device time, in %."""


def read(trace):
    return trace.roofline("kr")
