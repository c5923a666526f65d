"""What the plain references of the scenes share: the pixel grid, the
march's frozen-root gradient, the render in blocks of rows, the loss of
a fit, Adam, and the work a march does.

Plain PyTorch. Nothing here imports the program under test: a scene's
arithmetic is written out again in ``reference/<config>.py``, from the
published formulas, and the program's outputs are only judged against
it.

A scene module gives:

* ``N_PARAMS``;
* ``march(px, py, pv, n_steps, dtype) -> (t, hit, advances)``: the
  masked sphere trace of every lane, ``t`` in f32, ``advances`` the
  steps each lane moved (int32);
* ``residual(px, py, t, pv)``: the distance at parameter ``t`` along each
  lane's ray, differentiable in ``t`` and ``pv`` (the frozen root's
  equation);
* ``shade(px, py, t, hit, pv, create_graph)``: the Lambert shade at the
  root, differentiable in ``t`` and ``pv``.
"""

from __future__ import annotations

import torch

EPS = 1e-4        # the march's convergence distance in f32
T_MAX = 10.0      # the march's escape distance
GUARD = 1e-6      # a grazing root's slope is clamped to +-1 below this
BLOCK_ROWS = 1024  # rows of the image a block of the reference holds


def march_eps(dtype) -> float:
    """1e-4 in f32; two units of the last place in bf16, whose spacing
    near t = 1 the f32 distance could never reach."""
    return EPS if dtype == torch.float32 else 2.0 * torch.finfo(dtype).eps


def axis(n: int, extent: float, device) -> torch.Tensor:
    """The pixel coordinates of one row, ``col * step - extent`` in f32
    with the pitch ``2 * extent / (n - 1)`` rounded to f32."""
    step = torch.tensor(2.0 * extent / (n - 1), dtype=torch.float32)
    ext = torch.tensor(extent, dtype=torch.float32)
    return (torch.arange(n, device=device).to(torch.float32)
            * step.to(device) - ext.to(device))


def blocks(n: int, extent: float, device, rows: int = BLOCK_ROWS):
    """(row slice, px, py) for each block of ``rows`` rows of the (n, n)
    grid: x runs along a row, y down the rows."""
    ax = axis(n, extent, device)
    for r0 in range(0, n, rows):
        r1 = min(n, r0 + rows)
        py = ax[r0:r1, None].expand(r1 - r0, n)
        yield slice(r0, r1), ax[None, :].expand(r1 - r0, n), py


def render(scene, pv, n: int, n_steps: int, extent: float,
           dtype=torch.float32, keep_root: bool = False):
    """The (n, n) image of the scene vector ``pv``, block by block, and
    with ``keep_root`` the march's (t, hit) beside it."""
    pv = pv.detach().to(torch.float32)
    img = torch.empty((n, n), dtype=torch.float32, device=pv.device)
    t_all = torch.empty_like(img) if keep_root else None
    hit_all = (torch.empty((n, n), dtype=torch.bool, device=pv.device)
               if keep_root else None)
    for rs, px, py in blocks(n, extent, pv.device):
        with torch.no_grad():
            t, hit, _ = scene.march(px, py, pv, n_steps, dtype)
        img[rs] = scene.shade(px, py, t, hit, pv, False).detach()
        if keep_root:
            t_all[rs], hit_all[rs] = t, hit
    return (img, t_all, hit_all) if keep_root else img


def gradient(scene, pv, t, hit, g, n: int, extent: float):
    """The cotangent of the scene vector for the image cotangent ``g`` at
    the frozen roots ``t``: autograd through the shade, in ``pv`` and in
    ``t``, and the implicit function theorem for the root, whose residual
    is zero along the root as ``pv`` moves, so that dt/dpv = -(df/dpv) /
    (df/dt). Block by block, summed in f64."""
    pv = pv.detach().to(torch.float32)
    total = torch.zeros(pv.shape, dtype=torch.float64, device=pv.device)
    for rs, px, py in blocks(n, extent, pv.device):
        with torch.enable_grad():
            a = pv.clone().requires_grad_(True)
            tv = t[rs].clone().requires_grad_(True)
            img = scene.shade(px, py, tv, hit[rs], a, True)
            da, t_bar = torch.autograd.grad(img, (a, tv), grad_outputs=g[rs],
                                            allow_unused=True)
            da = torch.zeros_like(a) if da is None else da
            t_bar = torch.zeros_like(tv) if t_bar is None else t_bar
            a2 = pv.clone().requires_grad_(True)
            tv2 = t[rs].clone().requires_grad_(True)
            f = scene.residual(px, py, tv2, a2)
            (df_dt,) = torch.autograd.grad(f.sum(), tv2, retain_graph=True)
            sign = torch.where(df_dt == 0.0, -1.0, torch.sign(df_dt))
            slope = torch.where(df_dt.abs() > GUARD, df_dt, sign)
            w = torch.where(hit[rs], -t_bar / slope, 0.0)
            (di,) = torch.autograd.grad(f, a2, grad_outputs=w,
                                        allow_unused=True)
        total += da.double()
        if di is not None:
            total += di.double()
    return total.float()


def counts(scene, pv, n: int, n_steps: int, extent: float,
           dtype=torch.float32):
    """(evaluations, advances, hits) of the march over the whole grid:
    a lane evaluates the distance once per advance and once more, the
    evaluation that found it frozen or, at the step cap, the hit test's
    own."""
    pv = pv.detach().to(torch.float32)
    evals = adv = hits = 0
    for _, px, py in blocks(n, extent, pv.device):
        with torch.no_grad():
            _, hit, a = scene.march(px, py, pv, n_steps, dtype)
        adv += int(a.sum().item())
        evals += int(a.sum().item()) + a.numel()
        hits += int(hit.sum().item())
    return evals, adv, hits


def pool(img, ss: int):
    """The box filter of ``ss`` x ``ss`` samples to a pixel."""
    n = img.shape[-1] // ss
    return img.reshape(n, ss, n, ss).mean(dim=(1, 3))


def fit_loss(img, target, ss: int):
    """(loss, d loss / d img): the mean squared error of the filtered
    image against the target, and its cotangent on the samples."""
    with torch.enable_grad():
        x = img.detach().requires_grad_(True)
        loss = ((pool(x, ss) - target) ** 2).mean()
        (g,) = torch.autograd.grad(loss, x)
    return loss.detach(), g


class Adam:
    """Adam as Kingma and Ba state it, with bias correction; one vector
    of parameters."""

    def __init__(self, lr, betas=(0.9, 0.999), eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, betas[0], betas[1], eps
        self.m = self.v = None
        self.k = 0

    def step(self, p, g):
        g = g.to(torch.float32)
        if self.m is None:
            self.m, self.v = torch.zeros_like(g), torch.zeros_like(g)
        self.k += 1
        self.m = self.b1 * self.m + (1.0 - self.b1) * g
        self.v = self.b2 * self.v + (1.0 - self.b2) * g * g
        m_hat = self.m / (1.0 - self.b1 ** self.k)
        v_hat = self.v / (1.0 - self.b2 ** self.k)
        return p - self.lr * m_hat / (torch.sqrt(v_hat) + self.eps)


def fit_steps(scene, p0, target, steps: int, lr, betas, eps, n: int,
              n_steps: int, extent: float, ss: int, dtype=torch.float32):
    """``steps`` steps of the fit from ``p0``: (losses, the first
    gradient, the change of the parameters after the last step, the
    first step's image)."""
    opt = Adam(lr, betas, eps)
    p = p0.detach().to(torch.float32).clone()
    losses, first_grad, first_img = [], None, None
    for k in range(steps):
        img, t, hit = render(scene, p, n, n_steps, extent, dtype,
                             keep_root=True)
        loss, g = fit_loss(img, target, ss)
        grad = gradient(scene, p, t, hit, g, n, extent)
        losses.append(float(loss))
        if k == 0:
            first_grad, first_img = grad, img
        del t, hit, g
        if k > 0:
            del img
        p = opt.step(p, grad)
    return losses, first_grad, p - p0.to(torch.float32), first_img


class _Render(torch.autograd.Function):
    """The reference's render as a differentiable function of the scene
    vector: the image, and the gradient at the frozen roots."""

    @staticmethod
    def forward(ctx, p, scene, n, n_steps, extent, dtype):
        img, t, hit = render(scene, p, n, n_steps, extent, dtype,
                             keep_root=True)
        ctx.save_for_backward(p, t, hit)
        ctx.scene, ctx.n, ctx.extent = scene, n, extent
        return img

    @staticmethod
    def backward(ctx, g):
        p, t, hit = ctx.saved_tensors
        dp = gradient(ctx.scene, p, t, hit, g.contiguous(), ctx.n, ctx.extent)
        return (dp,) + (None,) * 5


class Module(torch.nn.Module):
    """The reference's render in a program's place: a module whose one
    parameter is the scene vector, marching in ``dtype``."""

    def __init__(self, scene, vec, n: int, n_steps: int, extent: float,
                 dtype=torch.float32):
        super().__init__()
        self.params = torch.nn.Parameter(vec.detach().to(torch.float32)
                                         .clone())
        self.scene, self.n, self.n_steps = scene, n, n_steps
        self.extent, self.dtype = extent, dtype

    def forward(self):
        return _Render.apply(self.params, self.scene, self.n, self.n_steps,
                             self.extent, self.dtype)
