"""Device milliseconds of the kernels launched inside the harness's VAE spans
(the first frames' encodes and the decode), per edit."""


def read(trace):
    return trace.vae_ms()
