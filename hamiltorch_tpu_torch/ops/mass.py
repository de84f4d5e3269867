"""Mass-matrix operators.

Counterpart of ``hamiltorch_tpu/ops/mass.py``.  Each operator has three
methods on ONE chain's momentum (the samplers ``torch.func.vmap`` them over
chains):

* ``sample(z)``   -> momentum ~ N(0, M), from a flat standard normal ``z``
* ``velocity(p)`` -> M^{-1} p           (the leapfrog drift direction)
* ``kinetic(p)``  -> 0.5 p^T M^{-1} p

``sample`` takes the standard normal instead of a key: the driver draws
``z`` for every chain from that chain's own generator (``utils/rng.py``)
outside any ``vmap``, and the tests hand in the JAX package's own draw.
Dense factors (the Cholesky of M) are computed once at construction.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ..utils.pytree import is_param_tree, tree_leaves, tree_map, tree_structure, tree_unflatten_like


@dataclasses.dataclass(frozen=True)
class IdentityMass:
    """M = I."""

    dim: int

    def sample(self, z):
        return z

    def velocity(self, p):
        return p

    def kinetic(self, p):
        return 0.5 * torch.dot(p, p)


@dataclasses.dataclass(frozen=True)
class DiagMass:
    """Diagonal mass given by its *inverse* diagonal (covariance scale)."""

    inv_diag: torch.Tensor

    def sample(self, z):
        return z * torch.rsqrt(self.inv_diag.to(z.dtype))

    def velocity(self, p):
        return self.inv_diag * p

    def kinetic(self, p):
        return 0.5 * torch.dot(p, self.inv_diag * p)


@dataclasses.dataclass(frozen=True)
class DenseMass:
    """Dense mass: ``inv_mass`` plus the Cholesky factor of M = inv_mass^-1."""

    inv_mass: torch.Tensor
    chol_mass: torch.Tensor

    @staticmethod
    def from_inv_mass(inv_mass: torch.Tensor) -> "DenseMass":
        mass = torch.linalg.inv(inv_mass)
        # symmetrize before factoring to absorb inversion round-off
        mass = 0.5 * (mass + mass.T)
        return DenseMass(inv_mass=inv_mass, chol_mass=torch.linalg.cholesky(mass))

    def sample(self, z):
        return self.chol_mass.to(z.dtype) @ z

    def velocity(self, p):
        return self.inv_mass @ p

    def kinetic(self, p):
        return 0.5 * torch.dot(p, self.inv_mass @ p)


@dataclasses.dataclass(frozen=True)
class BlockDiagMass:
    """Block-diagonal mass as one batched dense operator.

    Every block is padded to the largest block size K with an identity tail
    (so the padded operator stays SPD) and stacked to (B, K, K); one batched
    product replaces a loop over blocks.  ``mask`` marks the real lanes of
    the (B, K) layout and ``lane_idx`` their positions in it, in the flat
    order of the blocks.  As the other operators, ``sample`` takes a flat
    (D,) standard normal: it fills the real lanes, the padding stays 0.
    """

    inv_blocks: torch.Tensor  # (B, K, K) padded inverse-mass blocks
    chol_blocks: torch.Tensor  # (B, K, K) padded Cholesky factors of the mass
    mask: torch.Tensor  # (B, K) 1.0 for real lanes, 0.0 for padding
    lane_idx: torch.Tensor  # (D,) positions of the real lanes in (B K,)
    pad_idx: torch.Tensor  # (B K,) each lane's position in (D,), D for padding
    dim: int

    @staticmethod
    def from_inv_blocks(inv_blocks: Sequence[torch.Tensor]) -> "BlockDiagMass":
        sizes = [int(b.shape[0]) for b in inv_blocks]
        kmax = max(sizes)
        dim = sum(sizes)
        padded_inv, padded_chol, masks, lane_idx = [], [], [], []
        for bi, b in enumerate(inv_blocks):
            k = b.shape[0]
            pb = torch.eye(kmax, dtype=b.dtype, device=b.device)
            pb[:k, :k] = b
            mass = torch.linalg.inv(pb)
            mass = 0.5 * (mass + mass.T)
            padded_inv.append(pb)
            padded_chol.append(torch.linalg.cholesky(mass))
            masks.append((torch.arange(kmax, device=b.device) < k).to(b.dtype))
            lane_idx.append(torch.arange(k, device=b.device) + bi * kmax)
        lane_idx = torch.cat(lane_idx)
        pad_idx = torch.full((len(sizes) * kmax,), dim, dtype=torch.long, device=lane_idx.device)
        pad_idx[lane_idx] = torch.arange(dim, device=lane_idx.device)
        return BlockDiagMass(
            inv_blocks=torch.stack(padded_inv),
            chol_blocks=torch.stack(padded_chol),
            mask=torch.stack(masks),
            lane_idx=lane_idx,
            pad_idx=pad_idx,
            dim=dim,
        )

    def _scatter(self, blocked: torch.Tensor) -> torch.Tensor:
        """(B, K) padded lanes -> flat (D,)."""
        return blocked.reshape(-1)[self.lane_idx]

    def _gather(self, p: torch.Tensor) -> torch.Tensor:
        """Flat (D,) -> (B, K) padded lanes, zeros in the padding."""
        padded = torch.cat([p, p.new_zeros(1)])
        return padded[self.pad_idx].reshape(self.mask.shape)

    # the identity tails keep the padding lanes apart from the real ones, and
    # _scatter reads the real lanes only
    def sample(self, z):
        return self._scatter(
            torch.einsum("bij,bj->bi", self.chol_blocks.to(z.dtype), self._gather(z)))

    def velocity(self, p):
        return self._scatter(torch.einsum("bij,bj->bi", self.inv_blocks, self._gather(p)))

    def kinetic(self, p):
        pb = self._gather(p)
        v = torch.einsum("bij,bj->bi", self.inv_blocks, pb)
        return 0.5 * torch.sum(pb * v)


MassOperator = IdentityMass | DiagMass | DenseMass | BlockDiagMass


def tree_ravel(tree) -> torch.Tensor:
    """Concatenate a tree's leaves into one flat vector (leaf order)."""
    leaves = tree_leaves(tree)
    if len(leaves) == 1 and leaves[0].ndim == 1:
        return leaves[0]
    return torch.cat([leaf.reshape(-1) for leaf in leaves])


def tree_unravel_like(template, flat: torch.Tensor):
    """Split a flat vector back into a tree shaped like ``template``."""
    parts, off = [], 0
    for leaf in tree_leaves(template):
        n = leaf.numel()
        parts.append(flat[off:off + n].reshape(leaf.shape))
        off += n
    return tree_unflatten_like(template, parts)


@dataclasses.dataclass(frozen=True)
class TreeMass:
    """Mass operator over a parameter tree.

    Momentum is drawn as ONE flat normal and split into the leaves in
    sorted-key order, and kinetic energies reduce over the concatenated
    flat vector, as in the JAX package.  ``inv_diag_tree`` holds the
    per-leaf inverse-mass diagonal for a diagonal inner operator (leafwise
    drift); a dense inner operator drifts through a ravel round trip.
    """

    inner: MassOperator
    inv_diag_tree: object  # tree of per-leaf inverse diagonals, or None
    template: object  # the single-chain parameter tree (shapes only)

    def _unravel(self, flat: torch.Tensor):
        return tree_unravel_like(self.template, flat)

    def sample(self, z):
        return self._unravel(self.inner.sample(z))

    def velocity(self, p):
        if self.inv_diag_tree is not None:
            return tree_map(lambda d, x: d * x, self.inv_diag_tree, p)
        if isinstance(self.inner, IdentityMass):
            return p
        return self._unravel(self.inner.velocity(tree_ravel(p)))

    def kinetic(self, p):
        return self.inner.kinetic(tree_ravel(p))


def diag_tree_mass_view(metric_flat: torch.Tensor, template) -> TreeMass:
    """TreeMass view of a FLAT inverse-mass diagonal: the windowed-warmup
    bridge (adaptation carries the metric as one (D,) diagonal; the draw's
    transition drifts leafwise through this view)."""
    return TreeMass(
        inner=DiagMass(inv_diag=metric_flat),
        inv_diag_tree=tree_unravel_like(template, metric_flat),
        template=template,
    )


DENSE_TREE_WARMUP = (
    "adapt_mass='dense' is not supported with a pytree chain state "
    "— the dense metric operates on the flat layout; pass a flat "
    "(D,) theta0, or use diagonal adaptation."
)


def make_diag_mass_tree(inv_mass, params_template, what: str,
                        dense_requested: bool = False) -> TreeMass:
    """Validated TreeMass for a tree sampler entry, diagonal metrics only:
    a per-leaf or flat diagonal ``inv_mass`` (or None).  Dense and block
    metrics and dense windowed warmup take the flat path and raise here."""
    if dense_requested:
        raise ValueError(DENSE_TREE_WARMUP)
    mass = make_mass_tree(inv_mass, params_template)
    if isinstance(mass.inner, (DenseMass, BlockDiagMass)):
        raise ValueError(
            f"pytree {what} supports diagonal metrics only — pass "
            "inv_mass=None, a flat (D,) diagonal, or a per-leaf pytree of "
            "diagonals (dense/block inv_mass needs the flat (D,) theta0 "
            "path)."
        )
    return mass


def make_mass_tree(inv_mass, params_template) -> TreeMass:
    """Build a TreeMass for a parameter tree.

    ``inv_mass`` may be None (identity), a flat (D,) diagonal, a tree of
    per-leaf diagonals with ``params_template``'s structure, a dense (D, D)
    matrix, or a list of blocks, as in ``make_mass``.
    """
    dim = sum(leaf.numel() for leaf in tree_leaves(params_template))
    if inv_mass is not None and not isinstance(inv_mass, (list, tuple)):
        if tree_structure(inv_mass) == tree_structure(params_template):
            inner = make_mass(tree_ravel(inv_mass), dim)
            return TreeMass(inner=inner, inv_diag_tree=inv_mass, template=params_template)
        if is_param_tree(inv_mass):
            raise ValueError("a tree inv_mass must have the parameters' tree structure")
    inner = make_mass(inv_mass, dim)
    inv_diag_tree = None
    if isinstance(inner, DiagMass):
        inv_diag_tree = tree_unravel_like(params_template, inner.inv_diag)
    return TreeMass(inner=inner, inv_diag_tree=inv_diag_tree, template=params_template)


def make_mass(inv_mass, dim: int) -> MassOperator:
    """Build an operator from the reference's ``inv_mass`` convention.

    None -> identity; (D,) -> diagonal; (D, D) -> dense; a list or tuple of
    square blocks -> block-diagonal.
    """
    if inv_mass is None:
        return IdentityMass(dim=dim)
    if isinstance(inv_mass, (list, tuple)):
        op = BlockDiagMass.from_inv_blocks([torch.as_tensor(b) for b in inv_mass])
        if op.dim != dim:
            raise ValueError(f"inv_mass blocks cover {op.dim} dims, params have {dim}")
        return op
    inv_mass = torch.as_tensor(inv_mass)
    if inv_mass.shape[0] != dim:
        raise ValueError(f"inv_mass has dim {inv_mass.shape[0]}, params have {dim}")
    if inv_mass.ndim == 1:
        return DiagMass(inv_diag=inv_mass)
    if inv_mass.ndim == 2:
        return DenseMass.from_inv_mass(inv_mass)
    raise ValueError(
        f"inv_mass must be None, 1-d, 2-d, or a list of blocks; got ndim={inv_mass.ndim}"
    )
