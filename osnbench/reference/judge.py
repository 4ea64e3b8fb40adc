"""The comparison that decides a run's ``correct``: every call that the
window drove, judged against the objective evaluated in float64.

A call starts at w0 and returns its last iterate w with the f and the
gradient norm that the solver logged at it.  The reference works f and
grad f out again in float64, in blocks of rows, from the inputs the
benchmark made (the cell's objective's ``evaluate``), and reads the
program's outputs only to judge them.  Over the calls it returns:

* ``fval_gap``: |logged f - f(w)| / |f(w)|, the worst call;
* ``gnorm_gap``: |logged ||g|| - ||grad f(w)|| | / ||grad f(0)||, the worst
  call (measured against the problem's gradient at the origin, since the
  gradient at a solution is all but zero);
* ``grad_ratio``: ||grad f(w)|| / ||grad f(0)||, the worst call: how far
  the solve got (reported, not compared);
* ``opt_gap``, where the traffic states or limits it: (||grad f(w)||^2 /
  (2 lam)) / f(w), the worst call, which bounds f(w) - f* over f(w) for a
  lam-strongly convex f (lam the objective's ``lam``);
* ``not_fallen``: the calls whose gradient norm did not fall below the
  one at their start, which the line searches' step rules (Eqs. 5 and 6)
  rule out.

``per_call`` holds each call's numbers, which the cell's stated accuracy
judges one by one.

``audit`` judges the iterations that the run's audit kept from inside the
window (``osnbench/audit.py``): at each, the reference forms the gradient
at the program's iterate, the sketched Gram of the Hessian's square root
at that iterate under the draws the program's kernel received (the cell's
family's ``q``), and the direction from both, all in float64, and returns
the worst audit's

* ``grad_gap``: ||g - grad f(w)|| / ||grad f(0)||, the coded gradient;
* ``gram_gap``: ||H_hat - H_ref||_F / ||H_ref||_F, the sketch -> Gram
  kernel's output against the Gram of the same live blocks, the blocks
  and the Gram in float64 from A's coefficients formed in float64 or by
  the same plain formulas in float32, whichever is nearer: A in float32
  drops the rows whose logistic margin passes about 16.6 (their sigmoid
  rounds to 1), which moves the Gram by some 1e-5 near a solution, and
  the Gram kernel is judged apart from that;
* ``dir_gap``: ||H (p - p_ref)|| / ||H p_ref||, with H = the nearer H_ref plus the
  regularizer and p_ref its Cholesky or pinv solve of the gradient the
  program solved with: the direction, measured in H so that a pinv's null
  space does not count;
* ``audit_bad``: audits whose draws break the sketch's definition (a sign
  not +-1, draws not one a row of A, or what the family's ``draws_ok``
  rules out: a code outside [0, b), a row outside the padded range) or
  that keep fewer live blocks than the N = m / b that Alg. 2 waits for,
  or that lack the draws, the Gram or the direction.

The draws are the program's own state: the reference follows them, and
checks them by themselves through ``audit_bad``.

This module imports nothing of the program under test.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from osnbench.reference import control, sketch


def finite(call: dict) -> bool:
    return (math.isfinite(call["fval"]) and math.isfinite(call["gnorm"])
            and bool(torch.isfinite(call["w"]).all()))


def _wants_opt_gap(traffic: dict) -> bool:
    return "opt_gap" in traffic["accuracy"] or "opt_gap" in traffic["limits"]


def judge(cell: Dict, x: torch.Tensor, y: torch.Tensor, calls: List[dict],
          batch: int = 16) -> Dict:
    """``calls``: each {"w0": start, "w": iterate, "fval": logged f at w,
    "gnorm": logged gradient norm at w}, all finite (see ``finite``), of
    a run of ``cell``.  Returns the numbers over the calls and each call's
    accuracy."""
    cfg, evaluate = cell["config"], cell["objective"].evaluate
    out = {"fval_gap": None, "gnorm_gap": None, "grad_ratio": None,
           "not_fallen": 0, "per_call": [], "g0n": None}
    opt_gap = _wants_opt_gap(cell["traffic"])
    if opt_gap:
        out["opt_gap"] = None
        lam = cell["objective"].lam(cfg)
    if not calls:
        return out
    dim = calls[0]["w"].numel()
    _, g0 = evaluate(cfg, x, y, torch.zeros((1, dim)))
    g0n = out["g0n"] = float(torch.linalg.vector_norm(g0))
    for i in range(0, len(calls), batch):
        part = calls[i:i + batch]
        w = torch.stack([c["w"].reshape(-1) for c in part]
                        + [c["w0"].reshape(-1) for c in part])
        f, g = evaluate(cfg, x, y, w)
        gn = torch.linalg.vector_norm(g, dim=1).tolist()
        f = f.tolist()
        for j, c in enumerate(part):
            fi, gi, g_start = f[j], gn[j], gn[len(part) + j]
            one = {"fval_gap": abs(c["fval"] - fi) / abs(fi),
                   "gnorm_gap": abs(c["gnorm"] - gi) / g0n,
                   "grad_ratio": gi / g0n,
                   "not_fallen": 0 if gi < g_start else 1}
            if opt_gap:
                one["opt_gap"] = gi * gi / (2.0 * lam) / fi
            for k, v in one.items():
                if k == "not_fallen":
                    out[k] += v
                else:
                    out[k] = v if out[k] is None else max(out[k], v)
            out["per_call"].append(one)
    return out


def _draws_ok(family, draws: Dict, n_rows: int, n_blocks: int) -> bool:
    sig = draws["sigma"]
    if sig.shape[-1] != n_rows or draws["live"].numel() != sig.shape[0]:
        return False
    if draws["sigma_abs"] != (1.0, 1.0) or int(draws["live"].sum()) < n_blocks:
        return False
    return family.draws_ok(draws, n_rows)


def audit(cell: Dict, x: torch.Tensor, y: torch.Tensor,
          records: List[dict], g0n: float) -> Dict:
    """The worst audit's numbers (see the module's doc) of a run of
    ``cell``; ``g0n`` is ||grad f(0)||, worked out here when None."""
    cfg, traffic, obj = cell["config"], cell["traffic"], cell["objective"]
    evaluate, rows = obj.evaluate, obj.rows_per_sample(cfg)
    if g0n is None:
        _, g0 = evaluate(cfg, x, y, torch.zeros((1, x.shape[1] * rows)))
        g0n = float(torch.linalg.vector_norm(g0))
    out = {"grad_gap": None, "gram_gap": None, "dir_gap": None,
           "audit_bad": 0, "audits": len(records)}
    n_rows = x.shape[0] * rows
    n_blocks = int(traffic["sketch_dim"]) // int(traffic["block_size"])
    solver = control.solver_of(obj, traffic)
    lam = obj.lam(cfg)
    for rec in records:
        if not all(k in rec for k in ("draws", "gram", "g", "p")) \
                or not _draws_ok(cell["family"], rec["draws"], n_rows,
                                 n_blocks):
            out["audit_bad"] += 1
            continue
        w = rec["w"].reshape(-1).to(device=x.device, dtype=torch.float64)
        _, g_ref = evaluate(cfg, x, y, w[None])
        g_ref = g_ref[0]
        gram = rec["gram"].to(g_ref)
        gram_gap, h_ref = None, None
        for cdt in (torch.float64, torch.float32):
            h_c = sketch.gram(sketch.blocks(cell, x, y, w, rec["draws"],
                                            coef_dtype=cdt))
            gap = float(torch.linalg.matrix_norm(gram - h_c)
                        / torch.linalg.matrix_norm(h_c))
            if gram_gap is None or gap < gram_gap:
                gram_gap, h_ref = gap, h_c
            del h_c
        eye = torch.eye(h_ref.shape[0], dtype=h_ref.dtype,
                        device=h_ref.device)
        h = h_ref + lam * eye
        g = rec["g"].reshape(-1).to(g_ref)
        p = rec["p"].reshape(-1).to(g_ref)
        # the direction's stage is judged on the gradient it was handed,
        # which grad_gap judges by itself
        p_ref = control.direction(h, g, solver)
        one = {"grad_gap": float(torch.linalg.vector_norm(g - g_ref)) / g0n,
               "gram_gap": gram_gap,
               "dir_gap": float(torch.linalg.vector_norm(h @ (p - p_ref))
                                / torch.linalg.vector_norm(h @ p_ref))}
        del h_ref, h, gram
        for k, v in one.items():
            out[k] = v if out[k] is None else max(out[k], v)
    return out
