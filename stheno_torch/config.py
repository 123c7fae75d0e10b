"""Global numerical configuration.

Counterpart of ``stheno_tpu/config.py``: the dtype-aware Cholesky jitter,
the escalating-jitter policy, the dense-Cholesky implementation policy and
the cancellation-free distance switch, plus what only the PyTorch port
needs: the default device and the float32 matmul precision that the
library's numeric chokepoints set around their own work and restore on
exit (:func:`pin_matmul_precision`).

The default device is ``"cuda"``. Raw inputs (numpy arrays, Python
scalars, lists) are placed on it; tensors keep their own device. When the
default is CUDA and no card is present, converting a raw input raises
instead of running on the CPU: the CPU is used only when asked for
(``set_default_device("cpu")``, as the tests do).
"""

import contextlib
import functools

import torch

__all__ = [
    "epsilon",
    "jitter",
    "set_epsilon",
    "cholesky_impl",
    "set_cholesky_impl",
    "adaptive_jitter",
    "set_adaptive_jitter",
    "matmul_precision",
    "set_matmul_precision",
    "matmul_precision_ctx",
    "pin_matmul_precision",
    "tf32_products",
    "accurate_dists",
    "accurate_dists_enabled",
    "default_device",
    "set_default_device",
    "resolve_device",
    "as_tensor",
    "as_scalar",
    "capturing",
    "forward_mode_active",
    "no_host_sync",
]

#: Global jitter override. ``None`` means "dtype-aware default".
epsilon = None

_DTYPE_EPSILON = {
    torch.float64: 1e-12,
    torch.float32: 1e-8,
    torch.bfloat16: 1e-4,
}


def set_epsilon(value):
    """Set the global Cholesky jitter. ``None`` restores dtype-aware defaults."""
    global epsilon
    epsilon = value


#: Escalating-jitter Cholesky: when True, dense factorisations probe a
#: detached copy and multiply the jitter by 10 until the factor is finite.
#: Off by default, as in the reference's fixed ``B.epsilon`` semantics.
adaptive_jitter = False


def set_adaptive_jitter(value):
    """Enable/disable the escalating-jitter dense Cholesky policy."""
    global adaptive_jitter
    adaptive_jitter = bool(value)


#: Dense-Cholesky implementation policy. "auto" takes the carried-inverse
#: recursion (``ops/chol.py``, whose f32 base case is the hand-written tile
#: kernel) on a CUDA tensor of n >= 1024 through which a gradient flows,
#: and ``torch.linalg.cholesky`` otherwise. "xla" / "fast" force one choice
#: ("xla" keeps the JAX package's name for the library factorisation).
cholesky_impl = "auto"


def set_cholesky_impl(value):
    """Set the dense-Cholesky policy: "auto", "xla", or "fast"."""
    global cholesky_impl
    if value not in ("auto", "xla", "fast"):
        raise ValueError(f"unknown cholesky_impl: {value!r}")
    cholesky_impl = value


#: Precision of the library's float32 products on the card, set around
#: each numeric chokepoint and restored after it. TF32 keeps 10 mantissa
#: bits, the analogue on Hopper of the single-bf16-pass hazard the JAX
#: package measured on the TPU (an indefinite Gram, NaN NLML and gradients
#: off by tens of percent; see ``stheno_tpu/config.py`` on
#: ``matmul_precision``). "highest" (default): full float32, TF32 off in
#: cuBLAS and cuDNN; "high" or "medium": torch's reduced float32
#: precisions, TF32 allowed; ``None`` or "default": the caller's settings.
matmul_precision = "highest"

_PRECISIONS = (None, "default", "highest", "high", "medium")


def set_matmul_precision(value):
    """Set the float32 matmul precision of the library's numerics (see
    :data:`matmul_precision`)."""
    global matmul_precision
    if value not in _PRECISIONS:
        raise ValueError(f"unknown matmul_precision {value!r}; expected one of {_PRECISIONS}")
    matmul_precision = value


def _set_float32_flags(precision, cuda_tf32, cudnn_tf32):
    torch.set_float32_matmul_precision(precision)
    # set_float32_matmul_precision already sets cuBLAS's flag; writing it
    # again only where it differs keeps torch from seeing its legacy and
    # new precision settings mixed.
    if torch.backends.cuda.matmul.allow_tf32 != cuda_tf32:
        torch.backends.cuda.matmul.allow_tf32 = cuda_tf32
    torch.backends.cudnn.allow_tf32 = cudnn_tf32


@contextlib.contextmanager
def matmul_precision_ctx():
    """Context manager: :data:`matmul_precision` on entry
    (``torch.set_float32_matmul_precision`` and the cuBLAS and cuDNN TF32
    flags), the caller's settings restored on exit."""
    if matmul_precision in (None, "default"):
        yield
        return
    prev = (
        torch.get_float32_matmul_precision(),
        torch.backends.cuda.matmul.allow_tf32,
        torch.backends.cudnn.allow_tf32,
    )
    tf32 = matmul_precision != "highest"
    _set_float32_flags(matmul_precision, tf32, tf32)
    try:
        yield
    finally:
        _set_float32_flags(*prev)


@contextlib.contextmanager
def tf32_products():
    """Context manager: TF32 allowed in cuBLAS's float32 products (the
    TPU's ``"tensorfloat32"`` tile products, ``iterative.kernel_matvec``),
    the caller's flag restored on exit."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def pin_matmul_precision(fn):
    """Decorator: run ``fn`` under :func:`matmul_precision_ctx`. Applied at
    the library's numeric chokepoints (kernel evaluation, dense
    factorisations and solves and their backwards, the iterative entry
    points), so the pin holds there whatever the caller set, and nowhere
    else."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with matmul_precision_ctx():
            return fn(*args, **kwargs)

    return wrapper


#: When set, ``kernels.pw_dists2`` computes squared distances by direct
#: differencing instead of the matmul identity (cancellation-free near the
#: diagonal), and the fused Gram kernel is bypassed.
_accurate_dists = False


@contextlib.contextmanager
def accurate_dists(enable=True):
    """Context manager: cancellation-free pairwise distances."""
    global _accurate_dists
    prev = _accurate_dists
    _accurate_dists = bool(enable)
    try:
        yield
    finally:
        _accurate_dists = prev


def accurate_dists_enabled():
    """Whether the cancellation-free distance path is active."""
    return _accurate_dists


def jitter(dtype) -> float:
    """Cholesky jitter for ``dtype``: the global override if set, else a
    dtype-aware default (1e-12 for float64, 1e-8 for float32)."""
    if epsilon is not None:
        return epsilon
    return _DTYPE_EPSILON.get(dtype, 1e-8)


#: Device that raw inputs are placed on.
default_device = "cuda"


def set_default_device(value):
    """Set the device raw inputs are placed on (``"cuda"``, ``"cpu"``, ...)."""
    global default_device
    default_device = str(value)


def resolve_device(value=None):
    """Resolve ``value`` (default: :data:`default_device`) to a
    ``torch.device``. Raises when a CUDA device is asked for and there is
    none: the port never falls back to the CPU on its own."""
    dev = torch.device(default_device if value is None else value)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "stheno_torch runs on the GPU by default, but CUDA is not "
                "available. Call stheno_torch.config.set_default_device('cpu') "
                "(or pass device='cpu') to run on the CPU."
            )
    return dev


def as_tensor(x, dtype=None, device=None):
    """``x`` as a tensor. A tensor keeps its device (and is cast to
    ``dtype`` if given); anything else goes to ``resolve_device(device)``."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None or x.dtype == dtype else x.to(dtype)
    return torch.as_tensor(x, dtype=dtype, device=resolve_device(device))


def as_scalar(value, dtype, device):
    """``value`` (a tensor, a number or a 0-d array) as a 0-d tensor of
    ``dtype`` on ``device``. A number is filled in on the device, with no
    host-to-device copy, so a CUDA graph may capture it."""
    if isinstance(value, torch.Tensor):
        return value.to(dtype=dtype, device=device)
    return torch.full((), float(value), dtype=dtype, device=device)


_no_host_sync = False


@contextlib.contextmanager
def no_host_sync():
    """Context manager: run the enclosed code as a CUDA graph capture
    runs it. :func:`capturing` is true inside, so the checks that read a
    device value on the host are skipped, and every other host sync on the
    card raises (``torch.cuda.set_sync_debug_mode("error")``, where there
    is a card), naming its line. The Adam driver's warm-up and capture run
    under it."""
    global _no_host_sync
    card = torch.cuda.is_available()
    prev = _no_host_sync, torch.cuda.get_sync_debug_mode() if card else None
    _no_host_sync = True
    if card:
        torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        _no_host_sync = prev[0]
        if card:
            torch.cuda.set_sync_debug_mode(prev[1])


def capturing():
    """Whether the code runs as a CUDA graph capture: inside
    :func:`no_host_sync`, or while the current CUDA stream captures a
    graph. A capture allows no host sync, so the checks that read a device
    value on the host are skipped then, as the JAX package skips them under
    a trace."""
    return _no_host_sync or (
        torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()
    )


def forward_mode_active():
    """Whether a forward-mode derivative is being taken: a ``torch.func``
    jvp level (``jvp``, ``jacfwd``, ``hessian``) is on the transform stack,
    or a ``torch.autograd.forward_ad`` dual level is open."""
    from torch._C._functorch import TransformType, get_interpreter_stack

    if any(i.key() == TransformType.Jvp for i in get_interpreter_stack() or ()):
        return True
    return torch.autograd.forward_ad._current_level >= 0 and torch._C._is_fwd_grad_enabled()


def differentiated_again():
    """Whether a backward that runs now may itself be differentiated: grad
    mode is on inside it (``create_graph=True``) and, under ``torch.func``,
    a grad or jvp level lies outside the innermost one (``torch.func.grad``
    always differentiates with ``create_graph=True``, for its own level's
    sake)."""
    from torch._C._functorch import TransformType, get_interpreter_stack

    if not torch.is_grad_enabled():
        return False
    stack = get_interpreter_stack()
    if not stack:
        return True
    return any(i.key() in (TransformType.Grad, TransformType.Jvp) for i in stack[:-1])
