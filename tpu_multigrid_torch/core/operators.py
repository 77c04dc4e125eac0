"""Level operators.

* :class:`ConstStencilOp` is the constant-coefficient FEM Poisson stencil
  (diagonal 4, off-diagonals -1).  It carries no array state: applying it
  reads only the solution and right-hand-side grids.
* :class:`VarStencilOp` is a spatially varying 9-point stencil, stored as a
  ``(3, 3, S, S)`` coefficient array: variable-coefficient diffusion and
  the Galerkin coarse operators ``R A P`` built from it, and the shifted
  (Helmholtz) Poisson operator.
* :class:`VarStencilOp3D` is the 3D variable-coefficient 7-point flux
  stencil, stored as three transmissibility planes (and an optional
  reaction plane): 3D diffusion, re-discretized on every level.

The variable-coefficient operators are made in two ways, as in the JAX
package: on the host in numpy (``diffusion_op_host``,
``galerkin_coarsen_host``, ``diffusion_op3_host``), whose operators hold
numpy arrays until their ``to`` puts them on a device, and in torch
(``diffusion_op``, ``galerkin_coarsen``) on tensors where they lie.
"""

from __future__ import annotations

import numpy as np
import torch

from . import ops, ops3d


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


class ConstStencilOp3D:
    """h-independent 7-point Poisson operator on an (S, S, Sx) padded grid
    (``Sx`` the lane-aligned x side; cubic when None).  The cycle drivers
    dispatch the 3D transfers on ``ndim``."""

    ndim = 3

    def __init__(self, n: int, S: int, Sx: int = None):
        self.n = int(n)
        self.S = int(S)
        self.Sx = int(Sx) if Sx is not None else int(S)

    @property
    def grid_shape(self):
        return (self.S, self.S, self.Sx)

    def apply(self, u):
        return ops3d.apply_poisson3(u, self.n)

    def residual(self, u, b):
        return ops3d.residual3(u, b, self.n)

    def smooth(self, u, b, *, smoother: str, omega, sweeps: int):
        if smoother == "jacobi":
            return ops3d.jacobi_sweeps3(u, b, self.n, omega, sweeps)
        if smoother == "rbgs":
            return ops3d.redblack_gs_sweeps3(u, b, self.n, sweeps)
        raise ValueError(f"unknown smoother {smoother!r}")

    def __repr__(self):
        return f"ConstStencilOp3D(n={self.n}, S={self.S}, Sx={self.Sx})"


class Const19Op:
    """The compact 19-point Mehrstellen operator in 3D (fourth order),
    h-independent: ``A = (1/6)(24 I - 2 faces - edges)``, for the smoothed
    right-hand side ``h^2 (f + h^2/12 lap f)`` (``problems.poisson4_3d``).
    Carries no array state.

    ``STENCIL27[dz+1][dy+1][dx+1]`` multiplies ``u[i+dz, j+dy, k+dx]``
    (faces -1/3, edges -1/6, corners 0): the static weights the 3D level-
    visit kernels take (``kernels.transfer3d``)."""

    ndim = 3
    DIAG = 4.0
    STENCIL27 = tuple(
        tuple(tuple((4.0 if (dz, dy, dx) == (0, 0, 0) else
                     -2.0 / 6.0 if abs(dz) + abs(dy) + abs(dx) == 1 else
                     -1.0 / 6.0 if abs(dz) + abs(dy) + abs(dx) == 2 else
                     0.0)
                    for dx in (-1, 0, 1)) for dy in (-1, 0, 1))
        for dz in (-1, 0, 1))

    def __init__(self, n: int, S: int, Sx: int = None):
        self.n = int(n)
        self.S = int(S)
        self.Sx = int(Sx) if Sx is not None else int(S)

    @property
    def grid_shape(self):
        return (self.S, self.S, self.Sx)

    @staticmethod
    def _off_sum(u):
        """(2 * faces + edges) / 6, the negated off-diagonal part."""
        zp, zm = torch.roll(u, -1, -3), torch.roll(u, 1, -3)
        yp, ym = torch.roll(u, -1, -2), torch.roll(u, 1, -2)
        faces = (zp + zm + yp + ym
                 + torch.roll(u, 1, -1) + torch.roll(u, -1, -1))
        edges = torch.zeros_like(u)
        for a in (zp, zm):
            edges = (edges + torch.roll(a, 1, -2) + torch.roll(a, -1, -2)
                     + torch.roll(a, 1, -1) + torch.roll(a, -1, -1))
        for a in (yp, ym):
            edges = edges + torch.roll(a, 1, -1) + torch.roll(a, -1, -1)
        return (2.0 * faces + edges) * (1.0 / 6.0)

    def apply(self, u):
        return ops3d.mask_interior3(self.DIAG * u - self._off_sum(u), self.n)

    def residual(self, u, b):
        return ops3d.mask_interior3(b - self.DIAG * u + self._off_sum(u),
                                    self.n)

    def smooth(self, u, b, *, smoother: str, omega, sweeps: int):
        """Jacobi with D = 4I, or the parity-masked relaxation that the JAX
        package calls RB-GS: edges couple same-colour nodes, so each
        half-step updates its colour from the state before it."""
        if sweeps <= 0:
            return u
        m = ops3d.interior_mask3(u.shape[-3:], self.n, u.device)
        inv_d = 1.0 / self.DIAG
        if smoother == "jacobi":
            ws = omega if isinstance(omega, tuple) else (omega,)
            v = u
            for s in range(sweeps):
                w = ws[s % len(ws)]
                vn = (1.0 - w) * v + (w * inv_d) * (b + self._off_sum(v))
                v = torch.where(m, vn, 0.0)
            return v
        if smoother == "rbgs":
            par = ops3d.parity3(u.shape[-3:], u.device)
            v = u
            for _ in range(sweeps):
                for parity in (0, 1):
                    vn = inv_d * (b + self._off_sum(v))
                    v = torch.where(m & (par == parity), vn, v)
            return v
        raise ValueError(f"unknown smoother {smoother!r}")

    def __repr__(self):
        return f"Const19Op(n={self.n}, S={self.S}, Sx={self.Sx})"


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


def _put(a, device):
    """A numpy array or tensor as a tensor on ``device`` (None stays None)."""
    if a is None:
        return None
    t = torch.from_numpy(a) if isinstance(a, np.ndarray) else a
    return t.to(device)


class VarStencilOp3D:
    """Variable-coefficient 7-point flux stencil in 3D on an (S, S, Sx)
    padded grid.

    ``tx[i, j, k]`` couples node (i, j, k) to (i, j, k+1), and likewise
    ``ty`` along y and ``tz`` along z; the minus-direction coupling is the
    plane one node back (``t_minus`` = (tz at z-1, ty at y-1, tx at x-1),
    stored at set-up, else rolled).  ``c2`` is an optional reaction term
    c h^2 on the diagonal; ``inv_diag`` is built with it.  ``coef_stack``,
    when given, is the kernels' (3 or 4, S, S, Sx) stack [tz, ty, tx (, c2)]:
    the same values, and on a device tz / ty / tx / c2 are its planes, so
    the stack is the only copy.  ``apply``, ``residual`` and ``smooth``
    evaluate the JAX package's ``VarStencilOp3D`` term for term in its order;
    ``apply`` broadcasts over leading batch axes.  ``box`` (mixed boundary
    conditions) is not ported yet.
    """

    ndim = 3

    def __init__(self, tz, ty, tx, inv_diag, n: int, S: int, Sx: int,
                 c2=None, t_minus=None, coef_stack=None, box=None):
        if box is not None:
            raise NotImplementedError("box operators (mixed boundary "
                                      "conditions) are not ported yet")
        self.tz, self.ty, self.tx = tz, ty, tx
        self.inv_diag = inv_diag
        self.n = int(n)
        self.S = int(S)
        self.Sx = int(Sx)
        self.c2 = c2
        self.t_minus = tuple(t_minus) if t_minus is not None else None
        self.coef_stack = coef_stack

    @property
    def grid_shape(self):
        return (self.S, self.S, self.Sx)

    def to(self, device) -> "VarStencilOp3D":
        """The operator with every array as a tensor on ``device``; with a
        ``coef_stack`` the planes are views of the uploaded stack."""
        stack = _put(self.coef_stack, device)
        if stack is not None:
            tz, ty, tx = stack[0], stack[1], stack[2]
            c2 = stack[3] if stack.shape[0] == 4 else _put(self.c2, device)
        else:
            tz, ty, tx, c2 = (_put(a, device) for a in (self.tz, self.ty,
                                                        self.tx, self.c2))
        tm = None
        if self.t_minus is not None:
            tm = tuple(_put(a, device) for a in self.t_minus)
        return VarStencilOp3D(tz, ty, tx, _put(self.inv_diag, device),
                              self.n, self.S, self.Sx, c2=c2, t_minus=tm,
                              coef_stack=stack)

    def _tm(self):
        if self.t_minus is not None:
            return self.t_minus
        return (torch.roll(self.tz, 1, -3), torch.roll(self.ty, 1, -2),
                torch.roll(self.tx, 1, -1))

    def _diag(self, dtype):
        tzm, tym, txm = self._tm()
        d = self.tx + txm + self.ty + tym + self.tz + tzm
        if self.c2 is not None:
            d = d + self.c2
        return d.to(dtype)

    def _off_diag_apply(self, u):
        tzm, tym, txm = self._tm()
        acc = (self.tx * torch.roll(u, -1, -1) + txm * torch.roll(u, 1, -1)
               + self.ty * torch.roll(u, -1, -2) + tym * torch.roll(u, 1, -2)
               + self.tz * torch.roll(u, -1, -3)
               + tzm * torch.roll(u, 1, -3))
        return acc.to(u.dtype)

    def apply(self, u):
        out = self._diag(u.dtype) * u - self._off_diag_apply(u)
        return ops3d.mask_interior3(out.to(u.dtype), self.n)

    def residual(self, u, b):
        return ops3d.mask_interior3((b - self.apply(u)).to(u.dtype), self.n)

    def smooth(self, u, b, *, smoother: str, omega, sweeps: int):
        return smooth_flux3(self, u, b, smoother, omega, sweeps)

    def __repr__(self):
        return f"VarStencilOp3D(n={self.n}, S={self.S}, Sx={self.Sx})"


def smooth_flux3(op, u, b, smoother: str, omega, sweeps: int):
    """Weighted Jacobi (``omega`` a float or a per-sweep tuple) or RB-GS,
    (i+j+k) even first, of a 3D operator with ``inv_diag`` and
    ``_off_diag_apply`` (``VarStencilOp3D``, ``Directional7Op``), in the JAX
    package's order: (1-w) v + w inv_d (b + off), masked to the interior."""
    if sweeps <= 0:
        return u
    m = ops3d.interior_mask3(u.shape[-3:], op.n, u.device)
    inv_d = op.inv_diag.to(u.dtype)
    if smoother == "jacobi":
        ws = omega if isinstance(omega, tuple) else (omega,)
        v = u
        for s in range(sweeps):
            w = ws[s % len(ws)]
            vn = (1.0 - w) * v + w * inv_d * (b + op._off_diag_apply(v))
            v = torch.where(m, vn, 0.0)
        return v
    if smoother == "rbgs":
        par = ops3d.parity3(u.shape[-3:], u.device)
        v = u
        for _ in range(sweeps):
            for parity in (0, 1):
                vn = inv_d * (b + op._off_diag_apply(v))
                v = torch.where(m & (par == parity), vn.to(u.dtype), v)
        return v
    raise ValueError(f"unknown smoother {smoother!r}")


def _interior3_np(shape, n: int) -> np.ndarray:
    inter = np.zeros(shape, bool)
    inter[1:n, 1:n, 1:n] = True
    return inter


def diffusion_op3_host(cell_coeff, n: int, S: int, Sx: int) -> VarStencilOp3D:
    """3D -div(a grad u) as a 7-point flux stencil, in numpy on the host,
    from the (n, n, n) per-cell coefficients: the transmissibility of an
    edge is the mean of the four cells sharing it (``a == 1`` gives the
    7-point Poisson stencil).  The JAX package's arithmetic in its order:
    the planes equal its ``diffusion_op3_host`` bitwise.  tz / ty / tx are
    the planes of the (3, S, S, Sx) ``coef_stack``."""
    cells = np.asarray(cell_coeff)
    if cells.shape != (n, n, n):
        raise ValueError(f"cell_coeff must be ({n},{n},{n}), got "
                         f"{cells.shape}")
    dt = cells.dtype
    shape = (S, S, Sx)
    cpad = np.zeros((S + 1, S + 1, Sx + 1), dt)
    cpad[1:n + 1, 1:n + 1, 1:n + 1] = cells

    def cview(di, dj, dk):
        return cpad[di:di + S, dj:dj + S, dk:dk + Sx]

    stack = np.empty((3,) + shape, dt)
    # Edge (i,j,k) -> (i,j,k+1): the cells (i-1..i, j-1..j, k); likewise for
    # the y and z edges.
    stack[2] = 0.25 * (cview(0, 0, 1) + cview(0, 1, 1)
                       + cview(1, 0, 1) + cview(1, 1, 1))
    stack[1] = 0.25 * (cview(0, 1, 0) + cview(0, 1, 1)
                       + cview(1, 1, 0) + cview(1, 1, 1))
    stack[0] = 0.25 * (cview(1, 0, 0) + cview(1, 0, 1)
                       + cview(1, 1, 0) + cview(1, 1, 1))
    del cpad
    tz, ty, tx = stack[0], stack[1], stack[2]
    tzm, tym, txm = np.roll(tz, 1, 0), np.roll(ty, 1, 1), np.roll(tx, 1, 2)
    diag = tx + txm + ty + tym + tz + tzm
    inter = _interior3_np(shape, n)
    inv_diag = np.zeros(shape, dt)
    inv_diag[inter] = 1.0 / diag[inter]
    return VarStencilOp3D(tz, ty, tx, inv_diag, n, S, Sx,
                          t_minus=(tzm, tym, txm), coef_stack=stack)
