"""The numbers that decide `correct`, worked out from what the program
produced and what the reference produced on the same inputs."""
from __future__ import annotations

import statistics

import torch

# a leaf whose reference gradient norm is under this share of the median
# leaf's is left out of the gradient and change numbers: such a leaf moves
# under Adam by round-off alone
NEGLIGIBLE_LEAF = 1e-3


def norms(leaves) -> list:
    return [float(torch.linalg.vector_norm(x.double())) for x in leaves]


def kept_leaves(ref_grads) -> list:
    n = norms(ref_grads)
    med = statistics.median(n)
    return [i for i, v in enumerate(n) if v >= NEGLIGIBLE_LEAF * med]


def worst_leaf_gap(prog, ref, keep) -> float:
    """The widest gap between the program's norm of a leaf and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger."""
    p, r = norms(prog), norms(ref)
    med = statistics.median(r[i] for i in keep)
    return max(abs(p[i] - r[i]) / max(r[i], med) for i in keep)


def loss_gap(prog_losses, ref_losses) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(prog_losses, ref_losses))


def training_numbers(prog_losses, prog_first, prog_leaves0, prog_leaves3,
                     ref_losses, ref_first, ref_leaves0, ref_leaves3) -> dict:
    """loss_gap: the widest relative gap of a step's loss; first_loss_gap:
    the first step's alone (no update has amplified rounding yet);
    grad_gap: the first gradient's worst leaf; change_gap: the
    parameters' change over the steps, worst leaf."""
    keep = kept_leaves(ref_first)
    d_prog = [a.double() - b.double() for a, b in zip(prog_leaves3,
                                                      prog_leaves0)]
    d_ref = [a.double() - b.double() for a, b in zip(ref_leaves3,
                                                     ref_leaves0)]
    return {"loss_gap": loss_gap(prog_losses, ref_losses),
            "first_loss_gap": loss_gap(prog_losses[:1], ref_losses[:1]),
            "grad_gap": worst_leaf_gap(prog_first, ref_first, keep),
            "change_gap": worst_leaf_gap(d_prog, d_ref, keep)}
