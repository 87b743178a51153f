"""The decode of canonical 32-byte rows (`cuda_ops.decode_le32`) through
its plain version: the limbs against `Field.encode`, the stats against the
numpy passes they stand for, `load_witness`'s bit bounds and the
vanishing blind's draw.  No JAX and no compile: each test takes well under
a second on the CPU."""

import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from halo2_tpu_torch.fields import cuda_ops
from halo2_tpu_torch.fields.bn254 import FR_MODULUS as P, fr
from halo2_tpu_torch.io import load_witness, save_witness
from halo2_tpu_torch.plonk.vanishing import VanishingProver

MASK_253 = (1 << 253) - 1
EDGES = [0, 1, P - 1, MASK_253]


def _rows(cols) -> torch.Tensor:
    """Columns of ints below 2^256 -> (C, n, 8) int32 words."""
    blob = b"".join(x.to_bytes(32, "little") for col in cols for x in col)
    words = np.frombuffer(blob, dtype=np.int32).copy()
    return torch.from_numpy(words).reshape(len(cols), len(cols[0]), 8)


def _values(n, gen, top):
    return (EDGES + [gen.randrange(top) for _ in range(n)])[:n]


@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("n", [1, 7, 1000])
def test_plain_decode_equals_encode(n, mask):
    F = fr("cpu")
    gen = random.Random(n + 2 * mask)
    xs = _values(n, gen, 1 << 256 if mask else P)
    want = F.encode([x & MASK_253 if mask else x for x in xs])
    limbs, _ = cuda_ops.decode_le32(F, _rows([xs]), mask)
    assert limbs.shape == (16, 1, n)
    assert torch.equal(limbs[:, 0, :], want)
    blob = b"".join(x.to_bytes(32, "little") for x in xs)

    def fill(view):
        view[:] = np.frombuffer(blob, dtype=np.uint8)
    assert torch.equal(F.decode_le_rows(fill, 1, n, mask)[0][:, 0, :], want)
    if not mask:
        assert torch.equal(F.encode_le_bytes_dev(blob, n), want)


def _numpy_stats(cols, mask=False):
    """The word maxima and the >= p test of the host passes the kernel
    replaced (load_witness's `quad` maxima and `_below_p`)."""
    out = []
    p_words = [(P >> (64 * w)) & ((1 << 64) - 1) for w in range(4)]
    for col in cols:
        quad = np.array([[((x & MASK_253 if mask else x) >> (64 * w))
                          & ((1 << 64) - 1) for w in range(4)] for x in col],
                        dtype=np.uint64)
        lt = np.zeros(len(quad), dtype=bool)
        eq = np.ones(len(quad), dtype=bool)
        for w in (3, 2, 1, 0):
            lt |= eq & (quad[:, w] < np.uint64(p_words[w]))
            eq &= quad[:, w] == np.uint64(p_words[w])
        out.append([int(m) for m in quad.max(axis=0)] + [int(not lt.all())])
    return out


@pytest.mark.parametrize("mask", [False, True])
def test_stats_equal_numpy(mask):
    F = fr("cpu")
    gen = random.Random(17)
    n = 37
    cols = [[gen.randrange(1 << 64) for _ in range(n)],
            [gen.randrange(P) for _ in range(n)],
            [gen.randrange(1 << 150) for _ in range(n - 1)] + [P],
            [P + 1, 2 ** 256 - 1] + [gen.randrange(P) for _ in range(n - 2)],
            [0] * n]
    _, stats = cuda_ops.decode_le32(F, _rows(cols), mask)
    got = [[int(v) for v in row] for row in stats.numpy().view(np.uint64)]
    assert got == _numpy_stats(cols, mask)
    if not mask:
        assert [row[4] for row in got] == [0, 0, 1, 1, 0]


def test_rows_at_or_above_p_decode_mod_p():
    F = fr("cpu")
    xs = [P, P + 1, 2 ** 256 - 1, P - 1]
    limbs, _ = cuda_ops.decode_le32(F, _rows([xs]))
    assert F.decode(limbs[:, 0, :]) == [x % P for x in xs]


def test_decode_rejects_bad_shapes():
    F = fr("cpu")
    with pytest.raises(ValueError, match="32-byte rows"):
        F.encode_le_bytes_dev(bytes(33), 1)
    with pytest.raises(ValueError, match=r"\(C, n, 8\)"):
        cuda_ops.decode_le32(F, torch.zeros((1, 2, 7), dtype=torch.int32))


def _old_rule(col) -> int:
    """load_witness's bit bound as the host passes computed it."""
    quad = [[(x >> (64 * w)) & ((1 << 64) - 1) for w in range(4)]
            for x in col]
    maxima = [max(q[w] for q in quad) for w in range(4)]
    high = [w for w in (1, 2, 3) if maxima[w]]
    if not high:
        return max(maxima[0].bit_length(), 1)
    return 64 * high[-1] + maxima[high[-1]].bit_length()


def test_load_witness_bit_bounds(tmp_path):
    gen = random.Random(3)
    n = 19
    cols = [np.array([gen.randrange(1 << 40) for _ in range(n)],
                     dtype=np.uint64),
            [gen.randrange(1 << 170) for _ in range(n)],
            [gen.randrange(P) for _ in range(n - 1)] + [P - 1],
            np.zeros(n, dtype=np.uint64)]
    path = str(tmp_path / "w.bin")
    save_witness(cols, path)
    adv, bits = load_witness(path, device="cpu")
    ints = [[int(x) for x in col] for col in cols]
    assert bits == [_old_rule(col) for col in ints]
    assert bits[0] <= 40 and 128 < bits[1] <= 170 and bits[2] == 254
    assert bits[3] == 1
    F = fr("cpu")
    assert [F.decode(adv[:, c, :]) for c in range(len(cols))] == ints


def test_random_coeffs_formula():
    n = 64
    F = fr("cpu")
    rng, ref = random.Random(99), random.Random(99)
    got = VanishingProver._random_coeffs(rng, SimpleNamespace(F=F, n=n))
    blob = ref.randbytes(64 * n)
    row = [int.from_bytes(blob[32 * i: 32 * i + 32], "little") & MASK_253
           for i in range(2 * n)]
    assert F.decode(got) == [(row[i] + row[n + i] * 2 ** 253) % P
                             for i in range(n)]
    assert rng.getstate() == ref.getstate()
