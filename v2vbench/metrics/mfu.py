"""The model operations (UNet forwards and VAE calls of the reference at the
configuration's widths, counted on meta) of the untraced window's requests
over its wall seconds and 989 TFLOP/s, in %."""


def read(trace):
    return trace.mfu()
