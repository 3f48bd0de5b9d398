"""More optimizers: ``Rprop``, ``ASGD``, ``NAdam``, ``RAdam``, ``LBFGS``.

Port of ``paddle_tpu/optimizer/extra.py``, formula for formula, on the
`Optimizer` base of ``optimizer.py`` (its hooks, clip, L1 term, state
dict and step count).  ``ASGD``, ``NAdam`` and ``RAdam`` are multi-tensor
updates like the base's optimizers; ``Rprop`` picks each element's step
size by the sign of ``g * g_prev``, a per-tensor ``torch.where``.
``LBFGS`` is driven by a closure that re-evaluates the loss, and runs
eagerly on flat f32 vectors, as the reference does.  Scalar factors are
f32 tensors computed from the device step count, as the reference's traced
update computes them; NAdam's running momentum product and RAdam's
rectification switch (``rho_t > 5``, a ``torch.where``) stay on the device
too, so a replayed step under ``jit.to_static`` advances them.  ``LBFGS``
evaluates its closure and line search on the host and raises
``NotImplementedError`` under capture.
"""
from __future__ import annotations

import torch

from ..core.place import capturing
from .optimizer import Optimizer, bias_correction, steps_f32

__all__ = ["Rprop", "ASGD", "NAdam", "RAdam", "LBFGS"]


class Rprop(Optimizer):
    """Resilient backprop (extra.py:44-81): each element's step size
    grows by ``etas[1]`` while ``g * g_prev`` is positive and shrinks by
    ``etas[0]`` where it is negative, clipped to
    ``learning_rate_range``; on a sign change the step is skipped and
    the stored gradient zeroed; ``p = p - size*sign(g)``.  The step sizes
    start at the learning rate."""

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 multi_precision=False, name=None, **kw):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._lr_range = (float(learning_rate_range[0]),
                          float(learning_rate_range[1]))
        self._etas = (float(etas[0]), float(etas[1]))

    def _update(self, ps, pf, gf, flag, lr):
        lo, hi = self._lr_range
        eta_m, eta_p = self._etas
        for p, x, g in zip(ps, pf, gf):
            prev = self._acc("prev_grad", p)
            size = self._acc("step_size", p, init=lr)
            sign = torch.sign(g * prev)
            size.copy_(torch.clamp(
                torch.where(sign > 0, size * eta_p,
                            torch.where(sign < 0, size * eta_m, size)),
                lo, hi))
            g_eff = torch.where(sign < 0, 0.0, g)
            x.sub_(size * torch.sign(g_eff))
            prev.copy_(g_eff)


class ASGD(Optimizer):
    """Averaged SGD (extra.py:84-117): steps on a running mean ``d`` of
    the gradients over a window of ``batch_num`` steps, ``p = p -
    lr*d``, and keeps the running average of the iterates in ``ax``."""

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip, name)
        self._batch_num = max(1, int(batch_num))

    def _scalars(self, device):
        lr, step = self._device_state(device)
        t = steps_f32(step)
        return lr, t, torch.clamp_max(t, float(self._batch_num))

    def _update(self, ps, pf, gf, flag, s):
        lr, t, win = s
        ds = self._accs("grad_avg", ps)
        axs = self._accs("ax", ps)
        diff = torch._foreach_sub(gf, ds)
        torch._foreach_div_(diff, win)
        torch._foreach_add_(ds, diff)
        torch._foreach_sub_(pf, torch._foreach_mul(ds, lr))
        diff = torch._foreach_sub(pf, axs)
        torch._foreach_div_(diff, t)
        torch._foreach_add_(axs, diff)


class NAdam(Optimizer):
    """Adam with Nesterov momentum (Dozat 2016; extra.py:120-172), with
    the momentum schedule ``mu_t = b1*(1 - 0.5*0.96^(t*psi))`` and its
    running product, which the optimizer owns, a 0-d f32 tensor a device
    (it is not saved by ``state_dict``, as in the reference)."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip, name)
        self._b1, self._b2 = float(beta1), float(beta2)
        self._eps = float(epsilon)
        self._psi = float(momentum_decay)
        self._mu_products = {}      # device -> 0-d f32 running product

    def _scalars(self, device):
        """The step's factors; advances the running product of the
        momentum schedule."""
        b1, b2, psi = self._b1, self._b2, self._psi
        lr, step = self._device_state(device)
        t = steps_f32(step)
        mu_t = b1 * (1.0 - 0.5 * torch.pow(0.96, t * psi))
        mu_t1 = b1 * (1.0 - 0.5 * torch.pow(0.96, (t + 1.0) * psi))
        prod = self._mu_products.get(device)
        if prod is None:
            prod = self._mu_products[device] = torch.ones(
                (), dtype=torch.float32, device=device)
        mprod_t = prod * mu_t
        mprod_t1 = mprod_t * mu_t1
        prod.copy_(mprod_t)
        return (lr, mu_t1, 1.0 - mprod_t1, 1.0 - mu_t, 1.0 - mprod_t,
                bias_correction(b2, t))

    def _update(self, ps, pf, gf, flag, s):
        lr, mu_t1, c1, one_mu_t, c2, bc2 = s
        b1, b2 = self._b1, self._b2
        ms = self._accs("moment1", ps)
        vs = self._accs("moment2", ps)
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, gf, alpha=1 - b1)
        torch._foreach_mul_(vs, b2)
        torch._foreach_addcmul_(vs, gf, gf, value=1 - b2)
        m_hat = torch._foreach_mul(ms, mu_t1)
        torch._foreach_div_(m_hat, c1)
        part = torch._foreach_mul(gf, one_mu_t)
        torch._foreach_div_(part, c2)
        torch._foreach_add_(m_hat, part)
        del part
        den = torch._foreach_div(vs, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self._eps)
        torch._foreach_mul_(m_hat, lr)
        torch._foreach_div_(m_hat, den)
        torch._foreach_sub_(pf, m_hat)


class RAdam(Optimizer):
    """Rectified Adam (Liu et al. 2019; extra.py:175-219): Adam's
    moments, and the variance rectification ``rect`` once ``rho_t`` passes
    5; before that the step is the bias-corrected first moment alone."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip, name)
        self._b1, self._b2 = float(beta1), float(beta2)
        self._eps = float(epsilon)

    def _scalars(self, device):
        """lr, the bias corrections, the rectification and whether it
        applies (``rho_t > 5``), all on the device."""
        b1, b2 = self._b1, self._b2
        lr, step = self._device_state(device)
        t = steps_f32(step)
        rho_inf = 2.0 / (1.0 - b2) - 1.0
        b2t = torch.pow(b2, t)
        rho_t = rho_inf - 2.0 * t * b2t / (1.0 - b2t)
        rect = torch.sqrt(
            ((rho_t - 4) * (rho_t - 2) * rho_inf)
            / torch.clamp_min((rho_inf - 4) * (rho_inf - 2) * rho_t, 1e-8))
        return lr, bias_correction(b1, t), 1.0 - b2t, rect, rho_t > 5.0

    def _update(self, ps, pf, gf, flag, s):
        lr, bc1, bc2, rect, use_rect = s
        b1, b2 = self._b1, self._b2
        ms = self._accs("moment1", ps)
        vs = self._accs("moment2", ps)
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, gf, alpha=1 - b1)
        torch._foreach_mul_(vs, b2)
        torch._foreach_addcmul_(vs, gf, gf, value=1 - b2)
        upd = torch._foreach_div(ms, bc1)
        den = torch._foreach_div(vs, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self._eps)
        rected = torch._foreach_mul(upd, rect)
        torch._foreach_div_(rected, den)
        del den
        upd = [torch.where(use_rect, r, u) for r, u in zip(rected, upd)]
        torch._foreach_mul_(upd, lr)
        torch._foreach_sub_(pf, upd)


class LBFGS(Optimizer):
    """Limited-memory BFGS driven by a closure (extra.py:222-344):
    ``step(closure)`` evaluates the loss (the closure clears and computes
    the gradients), then runs up to ``max_iter`` iterations of the
    two-loop recursion over the last ``history_size`` (s, y) pairs, each
    a fixed step of the learning rate along the direction (no line
    search) or a backtracking search for sufficient decrease
    (``line_search_fn="strong_wolfe"``, as the reference approximates
    it).  The vectors are flat f32 on the parameters' device; the step
    count advances once a ``step``."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip, name)
        self.max_iter = int(max_iter)
        self.max_eval = (int(max_eval) if max_eval is not None
                         else self.max_iter * 5 // 4)
        self.tol_grad = float(tolerance_grad)
        self.tol_change = float(tolerance_change)
        self.history_size = int(history_size)
        if line_search_fn not in (None, "strong_wolfe"):
            raise ValueError(
                f"line_search_fn must be None or 'strong_wolfe', got "
                f"{line_search_fn!r}")
        self.line_search_fn = line_search_fn
        self._s, self._y = [], []

    def _flat(self, params, attr):
        wd = self._decay_coeff()
        vs = []
        for p in params:
            if attr == "p":
                v = p.detach().float()
            else:
                v = p.grad.float()
                if wd:
                    v = v + wd * p.detach().float()
            vs.append(v.reshape(-1))
        return torch.cat(vs)

    @staticmethod
    def _unflatten_to(params, flat):
        off = 0
        for p in params:
            n = p.numel()
            p.copy_(flat[off:off + n].reshape(p.shape))
            off += n

    @torch.no_grad()
    def step(self, closure=None):
        if capturing():
            raise NotImplementedError(
                "LBFGS under jit.to_static's capture is not ported yet: "
                "its closure and line search run on the host")
        if closure is None:
            raise ValueError("LBFGS.step requires a closure that "
                             "re-evaluates the loss")
        n_evals = [0]

        def eval_closure():
            with torch.enable_grad():
                loss = closure()
            n_evals[0] += 1
            return loss

        loss = eval_closure()
        params = self._params_with_grad()
        if not params:
            return loss
        if self._grad_clip is not None:
            self._grad_clip(params)
        for _ in range(self.max_iter):
            g = self._flat(params, "g")
            if float(g.abs().max()) <= self.tol_grad:
                break
            q = g
            alphas = []
            for s, y in reversed(list(zip(self._s, self._y))):
                rho = 1.0 / torch.clamp_min(torch.dot(y, s), 1e-10)
                a = rho * torch.dot(s, q)
                alphas.append((a, rho, s, y))
                q = q - a * y
            if self._y:
                y_last, s_last = self._y[-1], self._s[-1]
                gamma = torch.dot(s_last, y_last) / torch.clamp_min(
                    torch.dot(y_last, y_last), 1e-10)
                q = q * gamma
            for a, rho, s, y in reversed(alphas):
                b = rho * torch.dot(y, q)
                q = q + (a - b) * s
            d = -q
            x0 = self._flat(params, "p")
            t = float(self._current_lr())
            f0 = float(loss)
            gtd = float(torch.dot(g, d))
            if self.line_search_fn is None:
                self._unflatten_to(params, x0 + t * d)
                self.clear_grad()
                loss = eval_closure()
            else:
                for _ in range(10):
                    self._unflatten_to(params, x0 + t * d)
                    self.clear_grad()
                    loss = eval_closure()
                    if float(loss) <= f0 + 1e-4 * t * gtd:
                        break
                    t *= 0.5
            g_new = self._flat(params, "g")
            s_vec = t * d
            y_vec = g_new - g
            if float(torch.dot(s_vec, y_vec)) > 1e-10:
                self._s.append(s_vec)
                self._y.append(y_vec)
                if len(self._s) > self.history_size:
                    self._s.pop(0)
                    self._y.pop(0)
            if float(s_vec.abs().max()) <= self.tol_change:
                break
            if n_evals[0] >= self.max_eval:
                break
        self._advance()
        return loss
