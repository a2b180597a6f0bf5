"""Spectral normalisation as a function of the weight and the stored ``u``.

The weight is viewed as a (rows, cols) matrix with rows = its first
dimension: output features for an OIHW convolution or an (out, in) dense
weight, input channels for an IOHW transposed convolution, whose rows the
JAX package (and torch's ``spectral_norm``) also takes to be its input
channels. The JAX package's HWIO views differ only by a column permutation
(and a transposed kernel's spatial flip), which changes neither the
singular values nor ``u``.
A training forward runs one power iteration from the stored ``u``,

    v = normalize(Wᵀ u);  u = normalize(W v);  sigma = u · (W v),

and returns ``w / sigma`` with the new ``u`` for the caller to store. u and
v are constants for differentiation (computed without the graph);
gradients flow through sigma's dependence on w. Eval uses the stored ``u``
and recomputes v from it once, without updating.
"""

from __future__ import annotations

from typing import Tuple

import torch

EPS = 1e-12


def l2_normalize(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + EPS)


def matrix_view(w: torch.Tensor) -> torch.Tensor:
    """(shape[0], -1) view: (out, -1) of an OIHW convolution or an (out,
    in) dense weight, (in, -1) of an IOHW transposed convolution."""
    return w.reshape(w.shape[0], -1)


def power_iteration(
    w_mat: torch.Tensor, u: torch.Tensor, n_steps: int = 1
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``n_steps`` power iterations from ``u``; returns (sigma, u_new, v)
    with u_new and v detached and sigma differentiable in ``w_mat``."""
    with torch.no_grad():
        w = w_mat.detach()
        for _ in range(n_steps):
            v = l2_normalize(w.T @ u)
            u = l2_normalize(w @ v)
    return u @ (w_mat @ v), u, v


def spectral_normalize(
    w: torch.Tensor, u: torch.Tensor, update: bool, n_steps: int = 1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(w / sigma, u_new): one power iteration per call when ``update``
    (training), the stored ``u`` as it is otherwise (eval)."""
    w_mat = matrix_view(w)
    if update:
        sigma, u_new, _ = power_iteration(w_mat, u, n_steps)
    else:
        with torch.no_grad():
            v = l2_normalize(w_mat.detach().T @ u)
        sigma, u_new = u @ (w_mat @ v), u
    return w / sigma, u_new
