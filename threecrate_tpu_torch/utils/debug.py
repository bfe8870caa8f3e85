"""Debug hooks: the counterparts of the JAX package's NaN and jit switches.

Counterpart of ``threecrate_tpu.utils.debug``, which wraps JAX's debug
switches. What each counterpart does here:

* ``enable_nan_checks`` / ``nan_checks``: JAX's ``jax_debug_nans``
  raises ``FloatingPointError`` when a jitted computation produces a
  NaN. PyTorch has no such switch outside autograd, so these push a
  ``TorchDispatchMode`` that checks every floating output of every ATen
  op the process runs and raises ``FloatingPointError`` naming the op
  on the first NaN (infinities pass, as they do under
  ``jax_debug_nans``). Allocations whose memory is not yet written
  (``empty`` and its kin) are not checked. Each checked op costs one
  ``isnan`` reduction
  and, on the card, one host sync: for debugging only. Hand kernels
  launched through ``ctypes`` are not ATen ops and are not checked; the
  ops that read their outputs are.
* ``disable_jit``: JAX's runs pipelines op by op. The port runs eagerly
  already, so it changes nothing and only yields.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


# allocations whose memory is not yet written (it may hold any bits)
_UNWRITTEN = frozenset((torch.ops.aten.empty, torch.ops.aten.empty_like,
                        torch.ops.aten.empty_strided, torch.ops.aten.new_empty,
                        torch.ops.aten.new_empty_strided))


class _NanCheckMode(TorchDispatchMode):
    """Raises ``FloatingPointError`` when an op's floating output holds
    a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in _UNWRITTEN:
            return out
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.is_floating_point() \
                    and bool(torch.isnan(t).any()):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


# the mode that enable_nan_checks() entered, while it is on
_global_mode: Optional[_NanCheckMode] = None


def enable_nan_checks(enable: bool = True) -> None:
    """Raise on any NaN produced by an op from now on (``False``: stop)."""
    global _global_mode
    if enable and _global_mode is None:
        _global_mode = _NanCheckMode()
        _global_mode.__enter__()
    elif not enable and _global_mode is not None:
        mode, _global_mode = _global_mode, None
        mode.__exit__(None, None, None)


@contextlib.contextmanager
def nan_checks():
    """Scoped NaN checking for a suspicious pipeline stage."""
    with _NanCheckMode():
        yield


@contextlib.contextmanager
def disable_jit():
    """JAX's op-by-op switch; the port is eager, so this only yields."""
    yield
