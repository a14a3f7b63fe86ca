"""The gather wrappers on the CPU: their plain versions against jnp.take
(the Pallas probes' semantics, out[i] = table[idx[i]]), and the input
checks the CUDA path relies on.  Gathers do no arithmetic, so every
comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import n, small_threads, t  # noqa: F401
from veloslam_tpu_torch.registration import gather as ga


@pytest.mark.parametrize("N,M", [(65536, 8192), (4099, 1000), (7, 1),
                                 (5, 0)])
def test_gather_i32_matches_take(N, M):
    rng = np.random.default_rng(N + M)
    table = rng.integers(-1, 32768, N).astype(np.int32)
    idx = rng.integers(0, N, M).astype(np.int32)
    before = dict(ga.LAUNCHES)
    got = ga.gather_i32(t(table), t(idx))
    assert got.dtype == torch.int32 and tuple(got.shape) == (M,)
    np.testing.assert_array_equal(n(got), n(jnp.take(table, idx)))
    assert ga.LAUNCHES == before          # CPU tensors launch nothing


@pytest.mark.parametrize("V,M", [(32768, 4096), (1000, 999), (3, 1),
                                 (4, 0)])
def test_gather_rows8_matches_take(V, M):
    rng = np.random.default_rng(V + M)
    table = rng.standard_normal((V, 8)).astype(np.float32)
    idx = rng.integers(0, V, M).astype(np.int32)
    got = ga.gather_rows8(t(table), t(idx))
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, 8)
    np.testing.assert_array_equal(n(got), n(jnp.take(table, idx, axis=0)))


@pytest.mark.parametrize("case", ["table_dtype", "idx_dtype", "idx_2d",
                                  "table_2d", "rows_width", "strided"])
def test_gather_input_checks(case):
    table = torch.arange(16, dtype=torch.int32)
    rows = torch.zeros((16, 8))
    idx = torch.arange(4, dtype=torch.int32)
    calls = {
        "table_dtype": (ga.gather_i32, table.float(), idx, TypeError),
        "idx_dtype": (ga.gather_i32, table, idx.long(), TypeError),
        "idx_2d": (ga.gather_i32, table, idx.reshape(2, 2), ValueError),
        "table_2d": (ga.gather_i32, table.reshape(4, 4), idx, ValueError),
        "rows_width": (ga.gather_rows8, torch.zeros((16, 6)), idx,
                       ValueError),
        "strided": (ga.gather_rows8, rows, torch.arange(8,
                    dtype=torch.int32)[::2], ValueError),
    }
    fn, tab, ix, err = calls[case]
    with pytest.raises(err):
        fn(tab, ix)
