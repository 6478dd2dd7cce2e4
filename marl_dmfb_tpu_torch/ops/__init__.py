"""Hand-written CUDA kernels and their wrappers."""


def check_tensors(expect: dict, device, anchor: str):
    """Raise unless each ``name: (tensor, dtype, shape)`` of ``expect`` has
    that dtype and shape, lies on ``device`` (the tensor ``anchor``'s) and
    is contiguous: what a kernel's wrapper checks before it hands the
    pointers to C."""
    for name, (t, dtype, shape) in expect.items():
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, {anchor} on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
