"""Plain reference for the 3D Bratu problem -lap(u) - lam e^u = f on the
unit cube, homogeneous Dirichlet faces, nonlinear multigrid (FAS).

Plain torch, written from the configuration file alone: it imports nothing
of the program and takes nothing the program built.  Arrays are the
(n+1)^3 node grids (z, y, x), boundary nodes included (always zero); the
caller cuts the program's padded arrays down to them.

* The discrete system of level n (h = 1/n): N(u) = A u - h^2 lam e^u = b
  on the interior nodes, A the h-independent 7-point stencil (diagonal 6,
  neighbours -1), b = f h^2 on the finest level (``lambda`` and
  ``stencil`` of the configuration).
* Jacobi-Newton smoothing with the configuration's ``omega``: one Newton
  step per node on its own equation, u += omega (b - N(u)) / (6 - h^2 lam
  e^u), on the interior.
* The FAS level visit (``fas``): nu1 sweeps, the solution injected to the
  coarse level (u_c0 = u at the even nodes), the residual restricted by
  full weighting R = (4 / 8) P^T (``poisson_dirichlet.py``'s), the coarse
  equation N_c(u_c) = N_c(u_c0) + R (b - N(u)) solved from u_c0 by the
  coarse visit, the correction u += P (u_c - u_c0) with trilinear P, nu2
  sweeps.
* The coarsest level: ``coarse_newton_steps`` Newton steps on its dense
  interior Jacobian A - diag(h^2 lam e^u).  Torch's dense solver takes no
  type narrower than float32, so the solve of a narrower reference runs in
  float32 and its step is rounded to the reference's type.  A singular
  Jacobian (6 - h^2 lam e^u reaching 0, which only an iterate driven past
  the fold meets: the bfloat16 control's does at 513^3) gives a
  non-finite step, not an error, so that such a run reads as wrong.

It runs in any floating type, so that the same code is the float64
reference and, in bfloat16, the control that has to fail the check.
Building one turns TF32 off for torch's float32 products and cuDNN, so
that a float32 reference is float32.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent


def _sibling(name: str, path: Path):
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        sys.modules[name] = module
    return sys.modules[name]


poisson = _sibling("h100bench_reference_poisson_dirichlet_base",
                   HERE / "poisson_dirichlet.py")


class Reference(poisson.Reference):
    """The reference solver for one configuration, in ``dtype`` on
    ``device``."""

    def __init__(self, config: dict, dtype, device):
        if config["ndim"] != 3 or config["stencil"] != "fd7":
            raise ValueError("this reference takes the 3D fd7 stencil")
        mg, fas = config["multigrid"], config["fas"]
        if (fas["smoother"] != "jacobi-newton"
                or fas["solution_restriction"] != "injection"
                or mg["restriction"] != "fw" or mg["cycle"] != "V"
                or mg["coarse_solver"] != "direct"):
            raise ValueError("the reference runs Jacobi-Newton FAS V-cycles "
                             "with injection, full weighting and the dense "
                             "Newton coarsest solve only")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.d = 3
        self.diag = 6.0
        self.lam = float(config["lambda"])
        self.omega = float(mg["omega"])
        self.nu1, self.nu2 = mg["nu1"], mg["nu2"]
        self.newton_steps = fas["coarse_newton_steps"]
        self.ns = [2 ** lvl for lvl in range(mg["finest_level"],
                                             mg["coarsest_level"] - 1, -1)]
        self.scale = 4.0 / 2 ** self.d
        self.dtype, self.device = dtype, device
        self.a_coarse = torch.as_tensor(
            poisson.interior_matrix(self.ns[-1], 3, self.diag),
            device=device)

    # -- the operator ------------------------------------------------------

    def h2(self, k: int) -> float:
        return (1.0 / self.ns[k]) ** 2

    def nonlinear(self, u, k: int = 0):
        """N(u) = A u - h^2 lam e^u on the interior, zero on the
        boundary."""
        out = self.apply(u)
        c = self.inner()
        out[c] = out[c] - self.h2(k) * self.lam * torch.exp(u[c])
        return out

    def residual(self, u, b, k: int = 0):
        return b - self.nonlinear(u, k)

    def smooth(self, u, b, sweeps: int, k: int = 0):
        c = self.inner()
        h2lam = self.h2(k) * self.lam
        for _ in range(sweeps):
            r = self.residual(u, b, k)
            u = u.clone()
            u[c] = u[c] + self.omega * r[c] / (self.diag
                                               - h2lam * torch.exp(u[c]))
        return u

    # -- cycles ------------------------------------------------------------

    def coarse_newton(self, u, b):
        """Newton's method on the coarsest level's interior, dense."""
        k = len(self.ns) - 1
        c = self.inner()
        m = self.ns[k] - 1
        solve_dtype = (self.dtype if self.dtype in (torch.float32,
                                                    torch.float64)
                       else torch.float32)
        a = self.a_coarse.to(solve_dtype)
        for _ in range(self.newton_steps):
            r = self.residual(u, b, k)[c].reshape(-1)
            d = -self.h2(k) * self.lam * torch.exp(u[c]).reshape(-1)
            step = torch.linalg.solve_ex(a + torch.diag(d.to(solve_dtype)),
                                         r.to(solve_dtype))[0]
            u = u.clone()
            u[c] = u[c] + step.to(self.dtype).reshape((m,) * 3)
        return u

    def vcycle(self, u, b, k: int = 0):
        """One FAS V-cycle at level ``k`` from ``u``."""
        if k == len(self.ns) - 1:
            return self.coarse_newton(u, b)
        u = self.smooth(u, b, self.nu1, k)
        uc0 = torch.zeros_like(u[::2, ::2, ::2])
        uc0[self.inner()] = u[::2, ::2, ::2][self.inner()]
        bc = self.nonlinear(uc0, k + 1) + self.restrict(self.residual(u, b,
                                                                      k))
        uc = self.vcycle(uc0, bc, k + 1)
        u = u + self.prolong(uc - uc0)
        return self.smooth(u, b, self.nu2, k)
