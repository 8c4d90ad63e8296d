"""The port's shift probe on the CPU: its plain version against a numpy
statement of the step and against the JAX package's Pallas probe
(``tools/probe_misalign.py``, interpret mode), and the ``probe_shift.cu``
kernel source run as threaded host C++ against the plain version.

Every comparison is exact: the probe is integer xor on a fixed plane.
"""

import functools
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402
from test_torch_harness import build_host, ptr  # noqa: E402

from dynaalign_torch.tools import probe_misalign as probe  # noqa: E402
from dynaalign_torch.utils import profiling  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_KIND = {"base": "base", "shfl": "roll", "mis": "mis"}


def _jax_probe_module():
    spec = importlib.util.spec_from_file_location(
        "jax_probe_misalign", os.path.join(ROOT, "tools", "probe_misalign.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _seed(seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 30, size=(probe.MP1, probe.B), dtype=np.int32)


def _numpy_steps(seed, kind, n_steps):
    st = seed.copy()
    for g in range(n_steps):
        o = 16 + (g % 8) * 16
        a = st[o:o + probe.W].copy()
        b = {"base": a, "shfl": np.roll(a, 1, axis=0),
             "mis": st[o - 1:o - 1 + probe.W]}[kind]
        st[o:o + probe.W] = a ^ b
    return st


@pytest.mark.parametrize("kind", probe.KINDS)
def test_plain_equals_numpy_on_the_whole_plane(kind):
    seed = _seed(1)
    for n_steps in (1, 9, 20):
        got = probe.probe_plain(torch.from_numpy(seed), kind, n_steps)
        np.testing.assert_array_equal(got.numpy(),
                                      _numpy_steps(seed, kind, n_steps))
    # the window moved: rows outside every window stay, inside they change
    got = probe.probe_plain(torch.from_numpy(seed), kind, 8).numpy()
    np.testing.assert_array_equal(got[:15], seed[:15])
    np.testing.assert_array_equal(got[16 + 7 * 16 + probe.W:],
                                  seed[16 + 7 * 16 + probe.W:])
    assert not np.array_equal(got[16:16 + probe.W], seed[16:16 + probe.W])


@pytest.mark.parametrize("kind", probe.KINDS)
def test_plain_rows_0_8_equal_jax_probe(kind):
    jp = _jax_probe_module()
    seed = _seed(2)
    n_steps = 9
    out = pl.pallas_call(
        functools.partial(jp._kernel, kind=JAX_KIND[kind], n_steps=n_steps),
        grid=(n_steps,),
        in_specs=[pl.BlockSpec((jp.MP1, jp.B), lambda g: (0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((8, jp.B), lambda g: (0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((8, jp.B), jnp.int32),
        scratch_shapes=[pltpu.VMEM((jp.MP1, jp.B), jnp.int32)],
        interpret=True,
    )(jnp.asarray(seed))
    assert (jp.MP1, jp.B, jp.W) == (probe.MP1, probe.B, probe.W)
    got = probe.probe_plain(torch.from_numpy(seed), kind, n_steps)
    np.testing.assert_array_equal(got[:8].numpy(), np.asarray(out))


_PROBE_SHIM = r"""
#define __shared__
#include "probe_shift.cu"
int probe_plane[PROBE_BCOLS * PROBE_STRIDE];
extern "C" void probe_shift_host(const int* seed, int* out, int kind,
                                 int n_steps) {
  harness::launch(PROBE_BLOCKS, PROBE_THREADS, [&] {
    if (kind == 0) probe_shift_kernel<0>(seed, out, n_steps);
    if (kind == 1) probe_shift_kernel<1>(seed, out, n_steps);
    if (kind == 2) probe_shift_kernel<2>(seed, out, n_steps);
  }, probe_plane, PROBE_BCOLS * PROBE_STRIDE);
}
// blocks, threads, columns a block, lanes a column, rows a lane, the
// column stride in shared memory and the dynamic shared memory asked for
extern "C" void probe_shift_consts(int* out) {
  const int v[7] = {PROBE_BLOCKS, PROBE_THREADS, PROBE_BCOLS, PROBE_G,
                    PROBE_R, PROBE_STRIDE, PROBE_SMEM_BYTES};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
}
"""


@pytest.fixture(scope="module")
def probe_lib(tmp_path_factory):
    lib = build_host(tmp_path_factory.mktemp("probe_host"), "probe_shift",
                     _PROBE_SHIM)
    lib.probe_shift_host.restype = None
    lib.probe_shift_consts.restype = None
    return lib


@pytest.mark.parametrize("n_steps", [0, 1, 7, 20])
@pytest.mark.parametrize("kind", probe.KINDS)
def test_probe_source_equals_plain(probe_lib, kind, n_steps):
    """The whole grid through the host harness, every block a warp; 7 and
    20 steps are not multiples of 8, so the steps after the unrolled
    groups of 8 run too."""
    seed = _seed(3)
    out = np.full_like(seed, -1)
    probe_lib.probe_shift_host(ptr(seed), ptr(out), probe.KINDS.index(kind),
                               n_steps)
    ref = probe.probe_plain(torch.from_numpy(seed), kind, n_steps).numpy()
    np.testing.assert_array_equal(out, ref)


def test_probe_geometry_of_the_source(probe_lib):
    """The module's constants are the source's, and the layout is the NW
    kernels': a group of lanes a column whose rows split evenly, one warp a
    block, at least 128 blocks, each asking for more than half of an SM's
    228 KB of shared memory, so that no two share an SM; the column stride
    sends the warp's 32 lanes to 32 banks."""
    out = np.zeros(7, np.int32)
    probe_lib.probe_shift_consts(ptr(out))
    blocks, threads, bcols, g, r, stride, smem = out.tolist()
    assert (blocks, bcols, g, r) == (probe.BLOCKS, probe.BLOCK_COLS,
                                     probe.GROUP, probe.ROWS_PER_LANE)
    assert threads == 32 and bcols * g == threads and g * r == probe.W
    assert blocks * bcols == probe.B and blocks >= 128
    assert 2 * (smem + 1024) > 228 * 1024 and smem <= 227 * 1024
    assert stride >= probe.MP1 and bcols * stride * 4 <= smem
    for o in range(16, 16 + 8 * 16, 16):
        for i in range(r):
            banks = {(lane // g * stride + o + r * (lane % g) + i) % 32
                     for lane in range(threads)}
            assert len(banks) == 32


def test_probe_wrapper_on_cpu_and_its_checks():
    seed = torch.from_numpy(_seed(4))
    profiling.reset()
    got = probe.probe_shift(seed, "shfl", 5)
    assert "probe_shift" not in profiling.counters()
    assert torch.equal(got, probe.probe_plain(seed, "shfl", 5))
    with pytest.raises(ValueError, match="kind"):
        probe.probe_shift(seed, "roll", 1)
    with pytest.raises(TypeError, match="int32"):
        probe.probe_shift(seed.long(), "base", 1)
    with pytest.raises(ValueError, match="contiguous"):
        probe.probe_shift(seed[:100], "base", 1)
    with pytest.raises(ValueError, match="no probe kernel"):
        probe.probe_shift(seed.to("meta"), "base", 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe.run("base", device="cpu")


def test_probe_bound_counts_shared_memory_bytes():
    """A step reads and writes the [336, 256] window; mis adds one 4-byte
    load for each of the 128 * 32 lanes, shfl no shared memory; the bound
    spreads the bytes over the SMs the grid covers, 128 by default."""
    window = probe.W * probe.B * 4
    assert probe.smem_bytes_per_step("base") == 2 * window
    assert probe.smem_bytes_per_step("mis") == 2 * window + 128 * 32 * 4
    assert probe.smem_bytes_per_step("shfl") == 2 * window
    assert probe.bound_ns_per_step("base", 1.98e9) == pytest.approx(
        2 * window / (128 * 128) / 1.98)
    assert probe.bound_ns_per_step("base", 1.98e9) == pytest.approx(
        42 / 1.98)  # clocks a step on each SM
    assert probe.bound_ns_per_step("mis", 1.98e9, 64) == pytest.approx(
        (2 * window + 128 * 32 * 4) / (128 * 64) / 1.98)
