"""VQ-VAE training step: device ms a step spends in the convolutions'
kernels (every device operation the profiler links to a host operation
with ``convolution`` in its name: cuDNN's forward, transposed and backward
convolutions, their layout changes and FFT tiles) over the traced steps."""


def read(data):
    seconds = data.get("conv_device_s")
    if not seconds or not data.get("traced_steps"):
        return None
    return 1e3 * seconds / data["traced_steps"]
