"""Host waits on the device (stream, device and event synchronisations and
synchronous copies) inside the harness's UNet spans, per UNet forward."""


def read(trace):
    return trace.syncs_per_forward()
