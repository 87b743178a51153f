"""KZG structured reference string (Params) and commitment operations.

Analogue of halo2_proofs/src/poly/commitment.rs:
  * `Params { k, n, g, g_lagrange, s_g2 }` — the G1 bases live on the
    device as (2, 16, n) Montgomery limb tensors feeding the MSM; host
    copies exist only for (de)serialization.
  * `unsafe_setup` draws toxic s and builds both bases analytically
    (commitment.rs:56-124): the scalar tables (powers of s, Lagrange coeffs
    L_i(s)) are field operations on the device (`setup_scalars`), the n
    point multiplications of each basis one fixed-base comb of the
    generator (`g1.fixed_base_mul`).
  * `commit` / `commit_lagrange` wrap the Pippenger MSM
    (commitment.rs:129-222).
  * `write`/`read` reproduce the reference Params wire format (k LE u32,
    compressed g points, compressed g_lagrange, length-prefixed s_g2 bytes —
    commitment.rs:241-294) so SRS files interoperate.
  * `offload_lagrange` / `join_offload` move the Lagrange basis to host
    memory between a large proof's last Lagrange commitment and its
    extended-domain phases; every reader of `g_lagrange` brings it back
    (`_lagrange_dev`).
  * `use_mesh` routes the commitments through the sharded MSM
    (msm/distributed.py) over a mesh of devices (utils/mesh.py).
"""

from __future__ import annotations

import random

import torch

from halo2_tpu_torch.curves import g1, host
from halo2_tpu_torch.fields.bn254 import fr
from halo2_tpu_torch.msm.distributed import msm_many_sharded
from halo2_tpu_torch.msm.msm import msm_many
from halo2_tpu_torch.ntt.ntt import get_ntt, powers_dev
from halo2_tpu_torch.pairing import bn254 as pairing
from halo2_tpu_torch.transcript.blake2b import point_to_bytes
from halo2_tpu_torch.utils import mesh as mesh_mod
from halo2_tpu_torch.utils import offload, profiling
from halo2_tpu_torch.utils.device import require_device

Q = pairing.Q
R = pairing.R


# -- G2 compressed codec (64 bytes: x.c0 || x.c1 LE, y parity in top bit) ----

def _fq2_sqrt(a: pairing.FQ2):
    """Square root in Fq2 for q = 3 (mod 4) (Adj, Rodriguez-Henriquez)."""
    if a == pairing.FQ2.zero():
        return a
    a1 = a ** ((Q - 3) // 4)
    alpha = a1 * a1 * a
    x0 = a1 * a
    if alpha == pairing.FQ2((Q - 1, 0)):
        return pairing.FQ2((0, 1)) * x0  # i * x0
    b = (alpha + 1) ** ((Q - 1) // 2)
    x = b * x0
    return x if x * x == a else None


def g2_to_bytes(p) -> bytes:
    if p is None:
        return bytes(64)
    x, y = p
    out = bytearray(x.coeffs[0].to_bytes(32, "little") + x.coeffs[1].to_bytes(32, "little"))
    out[63] |= (y.coeffs[0] & 1) << 7
    return bytes(out)


def g2_from_bytes(b: bytes):
    arr = bytearray(b)
    sign = (arr[63] >> 7) & 1
    arr[63] &= 0x7F
    c0 = int.from_bytes(bytes(arr[:32]), "little")
    c1 = int.from_bytes(bytes(arr[32:]), "little")
    if c0 == 0 and c1 == 0 and sign == 0:
        return None
    x = pairing.FQ2((c0, c1))
    y = _fq2_sqrt(x * x * x + pairing.B2)
    if y is None:
        raise ValueError("invalid G2 point encoding")
    if y.coeffs[0] & 1 != sign:
        y = -y
    return (x, y)


class Params:
    """Prover parameters: SRS bases on the device + s_g2 for the verifier."""

    def __init__(self, k: int, g_dev, g_lagrange_dev, s_g2):
        self.k = k
        self.n = 1 << k
        self.g = g_dev                    # (2, 16, n) Montgomery affine
        self._g_lagrange = g_lagrange_dev  # (2, 16, n), see g_lagrange
        self._lagrange_copy = None        # an offload in flight
        self._lagrange_on_host = False
        self.s_g2 = s_g2                  # host G2 point (FQ2 pair)
        self.device = g_dev.device
        self.mesh = None                  # set by use_mesh
        self.mesh_axis = "x"
        self._mesh_bases = {}             # basis -> shards off self.device

    # sharded-MSM size gate: below it, one device is faster than paying
    # the per-shard fixed costs (the reference's >2^14 GPU-vs-CPU gate,
    # arithmetic.rs:442-458)
    MESH_MSM_MIN = 1 << 12

    def use_mesh(self, mesh, axis="x"):
        """Route every commitment of at least MESH_MSM_MIN points through
        the sharded MSM over `mesh` (utils/mesh.Mesh): the bases and the
        values shard over `axis` (one axis name, or a tuple outermost
        first for a 2-D mesh), the window totals reduce innermost axis
        first.  The prover also shards its iNTTs and h(X) over the mesh.
        mesh=None goes back to one device.  The mesh's first device must
        be the one the params live on."""
        if mesh is not None and mesh.devices_of(axis)[0] != self.device:
            raise ValueError(f"the mesh's first device is "
                             f"{mesh.devices_of(axis)[0]}, the params are "
                             f"on {self.device}")
        self.mesh = mesh
        self.mesh_axis = axis
        self._mesh_bases = {}
        return self

    def _bases_over_mesh(self, base: str, bases) -> tuple:
        """The bases as (x shards, y shards) over the mesh.  A shard on
        another device than the params' is copied there at its first use
        and kept, as the reference keeps the SRS resident on every GPU;
        one on the params' own device is a view of `bases`, so that an
        offload of the Lagrange basis still frees it."""
        devices = self.mesh.devices_of(self.mesh_axis)
        step = self.n // len(devices)
        kept = self._mesh_bases.setdefault(base, {})
        xs, ys = [], []
        for d, dev in enumerate(devices):
            x, y = (b.narrow(1, d * step, step) for b in bases)
            if dev != self.device:
                if d not in kept:
                    kept[d] = (mesh_mod.to(x, dev), mesh_mod.to(y, dev))
                x, y = kept[d]
            xs.append(x)
            ys.append(y)
        return xs, ys

    @property
    def g_lagrange(self):
        """The Lagrange basis, (2, 16, n) on the device; brought back
        first if it was offloaded."""
        return self._lagrange_dev()

    # -- device memory relief at large k (commitment.py:188-221) ----------
    def offload_lagrange(self):
        """Start moving the Lagrange basis to host memory (128 bytes a
        point, 512 MiB at k = 22); its device memory is freed by
        join_offload, and the next reader of g_lagrange brings it back.
        The prover calls this once its last Lagrange-basis commitment is
        made (create_proof(offload_lagrange=True))."""
        if self._lagrange_on_host or self._lagrange_copy is not None:
            return
        profiling.incr("lagrange_offloads")
        self._lagrange_copy = offload.HostCopy([self._g_lagrange])

    def join_offload(self):
        """Finish a pending offload: the device copy is released."""
        if self._lagrange_copy is not None:
            self._g_lagrange, = self._lagrange_copy.join()
            self._lagrange_copy = None
            self._lagrange_on_host = True

    def _lagrange_dev(self):
        self.join_offload()
        if self._lagrange_on_host:
            self._g_lagrange = offload.onload(self._g_lagrange, self.device)
            self._lagrange_on_host = False
        return self._g_lagrange

    # -- setup ----------------------------------------------------------
    @classmethod
    def unsafe_setup(cls, k: int, seed: int | None = None, device="cuda",
                     phases=None) -> "Params":
        """The SRS of 2^k points from a toxic s drawn from `seed`.  With
        `phases` (utils/profiling.PhaseTimes) it marks `scalars` (powers
        of s and Lagrange values), `g`, `g_lagrange` and `s_g2`."""
        device = require_device(device)
        mark = profiling.phase_marker(device, phases,
                                       scope="unsafe_setup")
        rng = random.Random(seed)
        s = rng.randrange(1, R)
        powers, lag = setup_scalars(k, s, device)
        mark("scalars")
        g_dev = torch.stack(g1.to_affine(g1.fixed_base_mul(powers)))
        del powers
        mark("g")
        gl_dev = torch.stack(g1.to_affine(g1.fixed_base_mul(lag)))
        del lag
        mark("g_lagrange")
        s_g2 = pairing.g2_mul(pairing.G2_GEN, s)
        mark("s_g2")
        return cls(k, g_dev, gl_dev, s_g2)

    # -- commitments ------------------------------------------------------
    def commit(self, coeffs):
        """Commit to coefficient-form poly values (16, n) Montgomery.
        Returns projective (X, Y, Z), each (16,)."""
        return tuple(c[:, 0] for c in self.commit_many([coeffs]))

    def commit_lagrange(self, values, max_bits: int = 256):
        """Commit to Lagrange-form values; max_bits enables the
        bounded-window fast path (commitment.rs:199-222)."""
        return tuple(c[:, 0] for c in self.commit_many(
            [values], [max_bits], base="lagrange"))

    def commit_many(self, columns, max_bits=None, base: str = "coeff"):
        """Commit several (16, n) columns against one basis ("coeff": g,
        "lagrange": g_lagrange) in one batched MSM.  Returns projective
        (X, Y, Z), each (16, C)."""
        if base not in ("coeff", "lagrange"):
            raise ValueError(f"unknown basis {base!r}")
        bases = self.g if base == "coeff" else self.g_lagrange
        if (self.mesh is not None and self.n >= self.MESH_MSM_MIN
                and self.n % self.mesh.size(self.mesh_axis) == 0):
            return msm_many_sharded(self._bases_over_mesh(base, bases),
                                    list(columns), self.mesh, self.mesh_axis,
                                    max_bits)
        return msm_many((bases[0], bases[1]), list(columns), max_bits)

    def commit_many_affine(self, columns, max_bits=None,
                           base: str = "coeff") -> list:
        """commit_many, then ONE batch inversion and one transfer to the
        host: the commitments as host affine points."""
        if not columns:
            return []
        return g1.decode_points(g1.to_affine(
            self.commit_many(columns, max_bits, base)))

    def verifier(self, public_inputs_size: int) -> "ParamsVerifier":
        gl_host = g1.decode_points(
            self.g_lagrange[:, :, :max(public_inputs_size, 1)])
        return ParamsVerifier(
            k=self.k,
            g1=host.G1_GEN,
            g2=pairing.G2_GEN,
            s_g2=self.s_g2,
            g_lagrange=gl_host[:public_inputs_size],
        )

    # -- serialization (reference wire format) ----------------------------
    def write(self, fh) -> None:
        fh.write(self.k.to_bytes(4, "little"))
        for base in (self.g, self.g_lagrange):
            for p in g1.decode_points(base):
                fh.write(point_to_bytes(p))
        extra = g2_to_bytes(self.s_g2)
        fh.write(len(extra).to_bytes(4, "little"))
        fh.write(extra)

    @classmethod
    def read(cls, fh, device="cuda") -> "Params":
        device = require_device(device)
        k = int.from_bytes(fh.read(4), "little")
        n = 1 << k
        g = g1.points_from_bytes(fh.read(32 * n), device)
        g_lagrange = g1.points_from_bytes(fh.read(32 * n), device)
        extra_len = int.from_bytes(fh.read(4), "little")
        s_g2 = g2_from_bytes(fh.read(extra_len))
        return cls(k, g, g_lagrange, s_g2)


class ParamsVerifier:
    """Verifier parameters (commitment.rs:33-40): tiny host-side struct."""

    def __init__(self, k: int, g1, g2, s_g2, g_lagrange):
        self.k = k
        self.n = 1 << k
        self.g1 = g1
        self.g2 = g2
        self.s_g2 = s_g2
        self.g_lagrange = g_lagrange  # host points, one per instance row

    def commit_lagrange(self, values: list) -> object:
        """Small host MSM over the instance Lagrange bases (Jacobian
        Pippenger — no per-op modular inversions)."""
        return host.msm_jacobian(self.g_lagrange[:len(values)], list(values))


def setup_scalars(k: int, s: int, device):
    """The scalars of the SRS of 2^k points, as (16, 2^k) standard-form
    limbs on `device`: the powers s^i, and the Lagrange values
    L_i(s) = (s^n - 1) / n * w^i / (s - w^i) (w the domain's root), the
    reference's host integers (halo2_tpu/poly/commitment.py:130-147) made
    by the field kernels: two powers tables, a subtraction, a batch
    inversion (zeros map to zero, as the reference's host inversion) and
    two products."""
    F = fr(device)
    n = 1 << k
    omega = get_ntt(k, device).omega
    multiplier = (pow(s, n, R) - 1) * pow(n, R - 2, R) % R
    s_pows = powers_dev(F, s, n)
    root_pows = powers_dev(F, omega, n)
    denom_invs = F.batch_inverse(F.sub(F.encode_scalar(s), root_pows))
    lag = F.mul(F.mul(root_pows, denom_invs), F.encode_scalar(multiplier))
    return F.from_mont(s_pows), F.from_mont(lag)
