"""The port's debug hooks and the repaired root, export and profiling
surface, against the JAX package on the CPU.

- ``utils.debug``: ``nan_checks`` raises ``FloatingPointError`` on a
  NaN an op produces (as ``jax_debug_nans`` does), not on a clean op,
  and leaves no dispatch mode behind; ``enable_nan_checks`` turns the
  same check on and off; ``disable_jit`` only yields (the port is
  eager). ``utils`` exports the three modules JAX's does.
- ``utils.profiling``: ``trace`` and ``median_time`` take JAX's
  parameters and defaults (``log_dir``, ``sync_fn``); ``median_time``
  still refuses to time without a card (the card test in
  ``tests/test_torch_cuda.py`` runs it with ``sync_fn``).
- ``core.axis_angle_to_matrix`` is exported, within 1e-6 of JAX's;
  ``native.HAS_NATIVE`` equals JAX's flag.
"""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch.utils._python_dispatch import _get_current_dispatch_mode  # noqa: E402

import threecrate_tpu.core as jcore  # noqa: E402
import threecrate_tpu.native as jnative  # noqa: E402
import threecrate_tpu.utils as jutils  # noqa: E402
from threecrate_tpu.utils import profiling as jprof  # noqa: E402

import threecrate_tpu_torch.core as tcore  # noqa: E402
import threecrate_tpu_torch.native as tnative  # noqa: E402
import threecrate_tpu_torch.utils as tutils  # noqa: E402
from threecrate_tpu_torch.utils import debug, profiling  # noqa: E402


def test_nan_checks_raise_on_a_nan_only():
    with debug.nan_checks():
        torch.ones(4).sum()
        torch.empty(1 << 16)                   # unwritten memory is not checked
        torch.tensor([1.0, float("inf")]) * 2.0
        with pytest.raises(FloatingPointError, match="div"):
            torch.zeros(1) / torch.zeros(1)
    assert _get_current_dispatch_mode() is None
    assert torch.isnan(torch.zeros(1) / torch.zeros(1)).all()


def test_enable_nan_checks_turns_the_check_on_and_off():
    debug.enable_nan_checks()
    try:
        debug.enable_nan_checks(True)          # idempotent
        with pytest.raises(FloatingPointError):
            torch.log(-torch.ones(2))
    finally:
        debug.enable_nan_checks(False)
    assert _get_current_dispatch_mode() is None
    assert torch.isnan(torch.log(-torch.ones(2))).all()
    debug.enable_nan_checks(False)             # already off: nothing to undo


def test_disable_jit_only_yields():
    with debug.disable_jit() as got:
        out = torch.arange(3) * 2
    assert got is None and out.tolist() == [0, 2, 4]


def test_utils_exports_match_jax():
    assert tutils.__all__ == jutils.__all__
    for name in ("enable_nan_checks", "nan_checks", "disable_jit"):
        assert callable(getattr(tutils.debug, name)) and callable(getattr(jutils.debug, name))


def test_profiling_signatures_match_jax():
    for name in ("trace", "median_time"):
        t = inspect.signature(getattr(profiling, name)).parameters
        j = inspect.signature(getattr(jprof, name)).parameters
        assert list(t) == list(j)
    assert inspect.signature(profiling.trace).parameters["log_dir"].default == \
        inspect.signature(jprof.trace).parameters["log_dir"].default
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            profiling.median_time(lambda: torch.ones(2), sync_fn=lambda out: None)


def test_axis_angle_and_has_native_match_jax():
    assert "axis_angle_to_matrix" in tcore.__all__
    for axis, angle in (([0, 0, 1.0], 0.3), ([1.0, -2.0, 0.5], -1.2), ([3.0, 0, 0], 2.5)):
        np.testing.assert_allclose(tcore.axis_angle_to_matrix(axis, angle).numpy(),
                                   np.asarray(jcore.axis_angle_to_matrix(
                                       np.float32(axis), np.float32(angle))), atol=1e-6)
    assert tnative.HAS_NATIVE is jnative.HAS_NATIVE is True
    from threecrate_tpu_torch.native import HAS_NATIVE
    assert HAS_NATIVE is True
