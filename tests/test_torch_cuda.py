"""The CUDA NW kernel on the card, against its plain version and the C++
oracle.  Without a card every test skips.  On a machine with one (and no
JAX, whose import in conftest.py would fail):

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dynaalign_torch import blosum, oracle, similarity_nw  # noqa: E402
from dynaalign_torch import similarity_nw_bucketed  # noqa: E402
from dynaalign_torch.encode import ALPHABET, encode  # noqa: E402
from dynaalign_torch.io.datasets import load_sequences  # noqa: E402
from dynaalign_torch.ops import MAX_MP1, nw_batch, nw_cuda  # noqa: E402
from dynaalign_torch.ops.nw import nw_similarity_batch  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _batch(dev, seed, n, alo, ahi, blo, bhi, pad_a=None, pad_b=None):
    rng = np.random.default_rng(seed)

    def seqs(lo, hi):
        return ["".join(rng.choice(list(ALPHABET), size=k))
                for k in rng.integers(lo, hi + 1, size=n)]

    ea, eb = encode(seqs(alo, ahi), pad_to=pad_a), encode(seqs(blo, bhi),
                                                          pad_to=pad_b)
    return [torch.from_numpy(x).to(dev)
            for x in (ea.indices, ea.lengths, eb.indices, eb.lengths)]


def _assert_kernel_equals_plain(args, sub, go=10, ge=4):
    got = nw_cuda.nw_similarity_batch_cuda(*args, sub, gap_open=go,
                                           gap_ext=ge)
    ref = nw_similarity_batch(*args, sub, gap_open=go, gap_ext=ge)
    torch.cuda.synchronize()
    assert torch.equal(got.matches, ref.matches)
    assert torch.equal(got.length, ref.length)


@pytest.mark.parametrize("gaps", [(10, 4), (5, 1), (12, 2)])
@pytest.mark.parametrize("matrix", blosum.MATRIX_NAMES)
def test_kernel_equals_plain_fuzz(cuda, matrix, gaps):
    args = _batch(cuda, 1, 1000, 1, 80, 1, 80)
    _assert_kernel_equals_plain(args, blosum.get_matrix(matrix, device=cuda),
                                *gaps)


@pytest.mark.parametrize("shape", [
    (300, 1, 40, 200, 566),  # m != n
    (300, 500, 566, 1, 30),
    (64, 1000, MAX_MP1 - 1, 900, MAX_MP1 - 1),  # the largest padded width
])
def test_kernel_equals_plain_shapes(cuda, shape):
    n, alo, ahi, blo, bhi = shape
    args = _batch(cuda, 2, n, alo, ahi, blo, bhi)
    _assert_kernel_equals_plain(args, blosum.get_matrix(device=cuda))


def test_similarity_nw_equals_oracle_through_kernel(cuda):
    seqs = load_sequences("evp_peparray", 160)
    nw_cuda.LAUNCHES = 0
    got = similarity_nw(seqs)
    assert nw_cuda.LAUNCHES > 0
    np.testing.assert_array_equal(got, oracle.nw_similarity(seqs))
    h3n2 = load_sequences("h3n2sample", 24)
    np.testing.assert_array_equal(similarity_nw(h3n2),
                                  oracle.nw_similarity(h3n2))


def test_bucketed_equals_oracle(cuda):
    seqs = (load_sequences("evp_peparray", 40)
            + load_sequences("h3n2sample", 12))
    np.testing.assert_array_equal(similarity_nw_bucketed(seqs, chunk=100),
                                  oracle.nw_similarity(seqs))


def test_xl_range_not_implemented(cuda):
    args = _batch(cuda, 3, 2, 5, 10, 5, 10, pad_a=MAX_MP1, pad_b=MAX_MP1)
    with pytest.raises(NotImplementedError, match="_kernel_xl"):
        nw_batch(*args, blosum.get_matrix(device=cuda))
    with pytest.raises(NotImplementedError, match="_kernel_xl"):
        similarity_nw(["A" * MAX_MP1, "ARND"])


def test_wrapper_rejects_int64_on_card(cuda):
    args = _batch(cuda, 4, 4, 1, 10, 1, 10)
    args[0] = args[0].long()
    with pytest.raises(TypeError, match="int32"):
        nw_cuda.nw_similarity_batch_cuda(*args, blosum.get_matrix(device=cuda))


def test_wrapper_rejects_length_past_width_on_card(cuda):
    args = _batch(cuda, 5, 4, 1, 10, 1, 10)
    args[1][0] = args[0].shape[1] + 1
    with pytest.raises(ValueError, match="lengths out of range"):
        nw_cuda.nw_similarity_batch_cuda(*args, blosum.get_matrix(device=cuda))
