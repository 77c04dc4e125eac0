"""Level operators.

* :class:`ConstStencilOp` is the constant-coefficient FEM Poisson stencil
  (diagonal 4, off-diagonals -1).  It carries no array state: applying it
  reads only the solution and right-hand-side grids.
* :class:`VarStencilOp` is a spatially varying 9-point stencil, stored as a
  ``(3, 3, S, S)`` coefficient array: variable-coefficient diffusion and
  the Galerkin coarse operators ``R A P`` built from it, and the shifted
  (Helmholtz) Poisson operator.

The variable-coefficient operators are made in two ways, as in the JAX
package: on the host in numpy (``diffusion_op_host``,
``galerkin_coarsen_host``), whose operators hold numpy arrays until
:meth:`VarStencilOp.to` puts them on a device, and in torch
(``diffusion_op``, ``galerkin_coarsen``) on tensors where they lie.
"""

from __future__ import annotations

import numpy as np
import torch

from . import ops


class ConstStencilOp:
    """FEM-scaled 5-point Poisson operator on an (S, S) padded node grid."""

    def __init__(self, n: int, S: int):
        self.n = int(n)
        self.S = int(S)

    def apply(self, u):
        return ops.apply_poisson(u, self.n)

    def residual(self, u, b):
        return ops.residual(u, b, self.n)

    def smooth(self, u, b, *, smoother: str, omega, sweeps: int):
        if smoother == "jacobi":
            return ops.jacobi_sweeps(u, b, self.n, omega, sweeps)
        if smoother == "rbgs":
            return ops.redblack_gs_sweeps(u, b, self.n, sweeps)
        raise ValueError(f"unknown smoother {smoother!r}")

    def __repr__(self):
        return f"ConstStencilOp(n={self.n}, S={self.S})"


def poisson_op(n: int, S: int) -> ConstStencilOp:
    return ConstStencilOp(n, S)


def _shift(u, di: int, dj: int):
    """u[i+di, j+dj] with wrap-around (callers mask non-interior nodes, the
    only ones a wrapped value reaches)."""
    out = u
    if di:
        out = torch.roll(out, -di, -2)
    if dj:
        out = torch.roll(out, -dj, -1)
    return out


def _sym_planes(c) -> list:
    """The kernels' coefficient planes of a (3, 3, S, S) stencil, in
    ``kernels.varstencil`` order: [diag, E, S, SE, SW]."""
    return [c[1, 1], c[1, 2], c[2, 1], c[2, 2], c[2, 0]]


def _minus_planes(c) -> list:
    """The four minus-direction planes [W, N, NW, NE] that a nonsymmetric
    operator's kernel planes append."""
    return [c[1, 0], c[0, 1], c[0, 0], c[0, 2]]


class VarStencilOp:
    """Spatially varying 9-point stencil operator.

    ``coef[di+1, dj+1, i, j]`` multiplies ``u[i+di, j+dj]`` in ``(A u)[i, j]``.
    ``inv_diag`` is the reciprocal of ``coef[1, 1]`` on the interior (zero
    elsewhere).  ``coef_sym`` optionally holds the kernels' coefficient
    planes, built once at set-up (:meth:`with_sym_planes`): five for a
    symmetric operator, nine when ``is_symmetric`` is False.

    The arrays are tensors, or numpy arrays while the host set-up assembles a
    hierarchy; :meth:`to` makes them tensors on a device.  ``apply``,
    ``residual`` and ``smooth`` evaluate the JAX package's ``VarStencilOp``
    term for term in the same order.  ``box`` (mixed Dirichlet/Neumann
    boundaries) is not ported yet.
    """

    def __init__(self, coef, inv_diag, n: int, S: int, box=None,
                 coef_sym=None, is_symmetric: bool = True):
        if box is not None:
            raise NotImplementedError("box operators (mixed boundary "
                                      "conditions) are not ported yet")
        self.coef = coef
        self.inv_diag = inv_diag
        self.n = int(n)
        self.S = int(S)
        self.box = None
        self.coef_sym = coef_sym
        self.is_symmetric = bool(is_symmetric)

    def with_sym_planes(self):
        """Attach the kernels' coefficient planes (numpy ``coef`` only; a
        no-op otherwise): (5, S, S) for a symmetric operator, the full
        (9, S, S) stack for a nonsymmetric one."""
        if self.coef_sym is None and isinstance(self.coef, np.ndarray):
            planes = _sym_planes(self.coef)
            if not self.is_symmetric:
                planes += _minus_planes(self.coef)
            self.coef_sym = np.stack(planes)
        return self

    def to(self, device) -> "VarStencilOp":
        """The operator with every array as a tensor on ``device`` (numpy
        arrays are converted, keeping their dtype)."""
        def put(a):
            if a is None:
                return None
            t = torch.from_numpy(a) if isinstance(a, np.ndarray) else a
            return t.to(device)
        return VarStencilOp(put(self.coef), put(self.inv_diag), self.n,
                            self.S, coef_sym=put(self.coef_sym),
                            is_symmetric=self.is_symmetric)

    def _mask(self, u):
        return ops.mask_interior(u, self.n)

    def apply(self, u):
        acc = self.coef[1, 1] * u
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                if di == 0 and dj == 0:
                    continue
                acc = acc + self.coef[di + 1, dj + 1] * _shift(u, di, dj)
        return self._mask(acc.to(u.dtype))

    def residual(self, u, b):
        return self._mask((b - self.apply(u)).to(u.dtype))

    def smooth(self, u, b, *, smoother: str, omega, sweeps: int):
        if sweeps <= 0:
            return u
        if smoother == "jacobi":
            return self._jacobi(u, b, omega, sweeps)
        if smoother == "rbgs":
            return self._rbgs(u, b, sweeps)
        if smoother in ("zebra_x", "zebra_y"):
            raise NotImplementedError("line smoothers (zebra_x / zebra_y) "
                                      "are not ported yet")
        raise ValueError(f"unknown smoother {smoother!r}")

    def _off_diag_apply(self, u):
        acc = torch.zeros_like(u)
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                if di == 0 and dj == 0:
                    continue
                acc = acc + self.coef[di + 1, dj + 1] * _shift(u, di, dj)
        return acc

    def _jacobi(self, u, b, omega, sweeps):
        m = ops.interior_mask(self.S, self.n, u.device)
        inv_d = self.inv_diag.to(u.dtype)
        ws = omega if isinstance(omega, tuple) else (omega,)
        v = u
        for s in range(sweeps):
            w = ws[s % len(ws)]
            vn = (1.0 - w) * v + w * inv_d * (b - self._off_diag_apply(v))
            v = torch.where(m, vn, 0.0)
        return v

    def _rbgs(self, u, b, sweeps):
        red, black = ops._parity_masks(self.S, self.n, u.device)
        inv_d = self.inv_diag.to(u.dtype)
        v = u
        for _ in range(sweeps):
            for color in (red, black):
                v = torch.where(color, v + inv_d * (b - self.apply(v)), v)
        return v

    def __repr__(self):
        return f"VarStencilOp(n={self.n}, S={self.S})"


def _interior_np(S: int, n: int) -> np.ndarray:
    i = np.arange(S)
    mrow = (i >= 1) & (i <= n - 1)
    return mrow[:, None] & mrow[None, :]


def _flux_coef(cpad, S: int, zeros):
    """The (3, 3, S, S) 5-point flux stencil from cells padded into an
    (S + 2, S + 2) frame: face transmissibilities are the means of the two
    cells sharing the face.  ``zeros`` makes the empty stack."""
    c_mm = cpad[0:S, 0:S]            # cell (i-1, j-1)
    c_mp = cpad[0:S, 1:S + 1]        # cell (i-1, j)
    c_pm = cpad[1:S + 1, 0:S]        # cell (i, j-1)
    c_pp = cpad[1:S + 1, 1:S + 1]    # cell (i, j)
    t_e = 0.5 * (c_mp + c_pp)
    t_w = 0.5 * (c_mm + c_pm)
    t_s = 0.5 * (c_pm + c_pp)
    t_n = 0.5 * (c_mm + c_mp)
    coef = zeros((3, 3, S, S))
    coef[1, 2] = -t_e
    coef[1, 0] = -t_w
    coef[2, 1] = -t_s
    coef[0, 1] = -t_n
    coef[1, 1] = t_e + t_w + t_s + t_n
    return coef


def diffusion_op(cell_coeff: torch.Tensor, n: int, S: int) -> VarStencilOp:
    """-div(a grad u) as a 5-point flux stencil from the (n, n) per-cell
    coefficients, as tensors on ``cell_coeff``'s device.  ``a == 1``
    reduces to the Poisson stencil."""
    if tuple(cell_coeff.shape) != (n, n):
        raise ValueError(f"cell_coeff must be ({n},{n}), got "
                         f"{tuple(cell_coeff.shape)}")
    cpad = cell_coeff.new_zeros((S + 2, S + 2))
    cpad[1:n + 1, 1:n + 1] = cell_coeff
    coef = _flux_coef(cpad, S, cell_coeff.new_zeros)
    m = ops.interior_mask(S, n, cell_coeff.device)
    coef = torch.where(m, coef, 0.0)
    diag = coef[1, 1]
    inv_diag = torch.where(m, 1.0 / torch.where(m, diag, 1.0), 0.0)
    return VarStencilOp(coef, inv_diag, n, S)


def diffusion_op_host(cell_coeff, n: int, S: int) -> VarStencilOp:
    """:func:`diffusion_op` in numpy on the host: the same arithmetic, the
    operator's arrays numpy until the hierarchy is put on a device."""
    cells = np.asarray(cell_coeff)
    if cells.shape != (n, n):
        raise ValueError(f"cell_coeff must be ({n},{n}), got {cells.shape}")
    dt = cells.dtype
    cpad = np.zeros((S + 2, S + 2), dt)
    cpad[1:n + 1, 1:n + 1] = cells
    coef = _flux_coef(cpad, S, lambda shape: np.zeros(shape, dt))
    m = _interior_np(S, n)
    coef = np.where(m[None, None], coef, np.zeros((), dt))
    diag = coef[1, 1]
    inv_diag = np.where(m, 1.0 / np.where(m, diag, np.ones((), dt)),
                        0.0).astype(dt)
    return VarStencilOp(coef, inv_diag, n, S)


def galerkin_coarsen_host(fine: VarStencilOp, Sc: int) -> VarStencilOp:
    """Coarse operator A_2h = R A_h P in closed form, on the host (numpy).

    For the fixed full-weighting / bilinear pair, R A P is a local formula:

        A_2h(I, I+d) = sum_{a,b} Rw[a] * A(2I+a, 2I+a+b) * Pw[a+b-2d]

    with ``a, b, d`` in {-1,0,1}^2 and ``Rw = Pw`` the FEM-scaled weights
    ([[1,2,1],[2,4,2],[1,2,1]]/4).  Terms whose fine column is a Dirichlet
    or padding node are dropped.  Computed in float64 for a float64 fine
    operator, else float32, in the JAX package's order, so both packages
    give the same coarse operator bitwise.
    """
    nf, Sf = fine.n, fine.S
    nc = nf // 2
    dt = fine.coef.dtype
    work_dt = np.float64 if dt == np.float64 else np.float32
    A = np.asarray(fine.coef, work_dt)

    # Padded fine frame with margin 2: index (2 + g) holds fine node g.
    W = 2 * Sc + 4
    lim = min(Sf, W - 2)
    F = np.zeros((3, 3, W, W), work_dt)
    F[:, :, 2:2 + lim, 2:2 + lim] = A[:, :, :lim, :lim]
    # Unknown-set indicator: the prolongation's column mask.
    If = np.zeros((W, W), work_dt)
    g = np.arange(W) - 2
    mr = (g >= 1) & (g <= nf - 1)
    If[np.ix_(mr, mr)] = 1.0

    Rw = np.array([[0.25, 0.5, 0.25], [0.5, 1.0, 0.5],
                   [0.25, 0.5, 0.25]], work_dt)

    def samp(arr, ir, ic):
        return arr[..., 2 + ir: 2 + ir + 2 * Sc: 2,
                   2 + ic: 2 + ic + 2 * Sc: 2]

    C2 = np.zeros((3, 3, Sc, Sc), work_dt)
    offs = (-1, 0, 1)
    for ar in offs:
        for ac in offs:
            ra = Rw[ar + 1, ac + 1]
            for br in offs:
                for bc in offs:
                    term = (ra * samp(F[br + 1, bc + 1], ar, ac)
                            * samp(If, ar + br, ac + bc))
                    for dr in offs:
                        cr = ar + br - 2 * dr
                        if abs(cr) > 1:
                            continue
                        for dc in offs:
                            cc = ac + bc - 2 * dc
                            if abs(cc) > 1:
                                continue
                            C2[dr + 1, dc + 1] += Rw[cr + 1, cc + 1] * term

    m = _interior_np(Sc, nc)
    C2 = np.where(m[None, None], C2, 0.0)
    diag = C2[1, 1]
    inv_diag = np.where(m, 1.0 / np.where(m, diag, 1.0), 0.0)
    return VarStencilOp(C2.astype(dt), inv_diag.astype(dt), nc, Sc,
                        is_symmetric=fine.is_symmetric)


def _setup_transfers(Sf: int, Sc: int, like: torch.Tensor):
    """The transfer pair of the Galerkin probe: the CUDA transfer kernels
    for float32 level pairs on the card that they take, else the plain
    operators."""
    from ..kernels import transfer as _t
    if (like.is_cuda and like.dtype == torch.float32
            and _t.supported(Sf, Sc, 0, like.dtype)):
        def pro(e, nc, S):
            return _t.prolong_add(e.new_zeros((S, S)), e, 2 * nc)

        def res(r, nf, Sc_):
            return _t.restrict_fw(r, nf, Sc_)

        return pro, res
    return ops.prolong, ops.restrict_fw


def galerkin_coarsen(fine: VarStencilOp, Sc: int) -> VarStencilOp:
    """Coarse operator A_2h = R A_h P by probing: ``R A P`` applied to nine
    coarse comb grids (ones on the nodes congruent to (p, q) mod 3).  Each
    coarse node's 3x3 neighbourhood holds exactly one comb node, so the nine
    responses separate every stencil entry.  Tensors on ``fine``'s device;
    an independent check of :func:`galerkin_coarsen_host`."""
    nf, Sf = fine.n, fine.S
    nc = nf // 2
    like = fine.coef
    dt, dev = like.dtype, like.device
    prolong_fn, restrict_fn = _setup_transfers(Sf, Sc, like)
    i = torch.arange(Sc, device=dev)[:, None].expand(Sc, Sc)
    j = torch.arange(Sc, device=dev)[None, :].expand(Sc, Sc)

    resp = [[None] * 3 for _ in range(3)]
    for p in range(3):
        for q in range(3):
            # Combs are not masked to the interior: rows of interior nodes
            # next to the boundary still probe boundary columns, which the
            # masked apply() zeroes.
            comb = ((i % 3 == p) & (j % 3 == q)).to(dt)
            resp[p][q] = restrict_fn(fine.apply(prolong_fn(comb, nc, Sf)),
                                     nf, Sc)

    coef = like.new_zeros((3, 3, Sc, Sc))
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            pi = (i + di) % 3
            qj = (j + dj) % 3
            val = like.new_zeros((Sc, Sc))
            for pp in range(3):
                for qq in range(3):
                    val = torch.where((pi == pp) & (qj == qq), resp[pp][qq],
                                      val)
            coef[di + 1, dj + 1] = val

    m = ops.interior_mask(Sc, nc, dev)
    coef = torch.where(m, coef, 0.0)
    diag = coef[1, 1]
    inv_diag = torch.where(m, 1.0 / torch.where(m, diag, 1.0), 0.0)
    return VarStencilOp(coef, inv_diag, nc, Sc)
