"""Closed-form cubic root solve for the 4th-order Taylor step size.

The reference forms p(x) = 4E x^3 + 3D x^2 + 2C x + B (the derivative of the
quartic Taylor expansion of the RKHS inner product along the flow) and picks
the smallest positive real root via companion-matrix eigenvalues
(reference: src/cvo/CvoGPU.cu:1128-1163, src/cvo/LieGroup.cpp:290-340,
poly_solver_order3).

jit has no complex eigendecomposition on accelerators, so we solve the cubic
in closed form
with real arithmetic only: the trigonometric method when the discriminant says
three real roots, Cardano's single real root otherwise. Branches are selected
with `jnp.where` over guarded operands so the whole thing lives inside jit.
"""

from __future__ import annotations

import jax.numpy as jnp

_BIG = jnp.inf


def cubic_real_roots(a, b, c, d):
    """Real roots of a x^3 + b x^2 + c x + d.

    Returns (roots[3], valid[3]); invalid lanes hold +inf. Degenerate leading
    coefficients fall back to the quadratic / linear solve.
    """
    a, b, c, d = (jnp.asarray(v, jnp.float32) for v in (a, b, c, d))
    tiny = 1e-30

    # ---- cubic path (|a| meaningful) ----
    safe_a = jnp.where(jnp.abs(a) < tiny, 1.0, a)
    bn, cn, dn = b / safe_a, c / safe_a, d / safe_a
    # depressed cubic t^3 + p t + q, x = t - bn/3
    shift = bn / 3.0
    p = cn - bn * bn / 3.0
    q = 2.0 * bn**3 / 27.0 - bn * cn / 3.0 + dn
    disc = -4.0 * p**3 - 27.0 * q * q  # >0 -> three distinct real roots

    # trig method (requires p < 0)
    safe_p = jnp.minimum(p, -tiny)
    m = 2.0 * jnp.sqrt(-safe_p / 3.0)
    arg = jnp.clip(3.0 * q / (safe_p * m), -1.0, 1.0)
    theta = jnp.arccos(arg) / 3.0
    two_pi_3 = 2.0 * jnp.pi / 3.0
    trig_roots = jnp.stack(
        [
            m * jnp.cos(theta),
            m * jnp.cos(theta - two_pi_3),
            m * jnp.cos(theta - 2.0 * two_pi_3),
        ]
    ) - shift

    # Cardano single real root (disc <= 0)
    rad = jnp.sqrt(jnp.maximum(q * q / 4.0 + p**3 / 27.0, 0.0))
    u = jnp.cbrt(-q / 2.0 + rad)
    v = jnp.cbrt(-q / 2.0 - rad)
    cardano_root = u + v - shift

    three_real = disc > 0
    cubic_roots = jnp.where(
        three_real,
        trig_roots,
        jnp.stack([cardano_root, _BIG, _BIG]),
    )
    cubic_valid = jnp.where(
        three_real, jnp.ones(3, bool), jnp.array([True, False, False])
    )

    # ---- quadratic fallback b x^2 + c x + d (a ~ 0) ----
    safe_b = jnp.where(jnp.abs(b) < tiny, 1.0, b)
    qdisc = c * c - 4.0 * b * d
    sq = jnp.sqrt(jnp.maximum(qdisc, 0.0))
    quad_roots = jnp.stack([(-c + sq) / (2.0 * safe_b), (-c - sq) / (2.0 * safe_b), _BIG])
    quad_ok = qdisc >= 0
    quad_valid = jnp.stack([quad_ok, quad_ok, jnp.zeros((), bool)])

    # ---- linear fallback c x + d (a ~ 0, b ~ 0) ----
    safe_c = jnp.where(jnp.abs(c) < tiny, 1.0, c)
    lin_roots = jnp.stack([-d / safe_c, _BIG, _BIG])
    lin_valid = jnp.array([True, False, False]) & (jnp.abs(c) >= tiny)

    use_quad = jnp.abs(a) < tiny
    use_lin = use_quad & (jnp.abs(b) < tiny)
    roots = jnp.where(use_lin, lin_roots, jnp.where(use_quad, quad_roots, cubic_roots))
    valid = jnp.where(use_lin, lin_valid, jnp.where(use_quad, quad_valid, cubic_valid))
    roots = jnp.where(jnp.isfinite(roots) & valid, roots, _BIG)
    return roots, valid


def step_from_poly(B, C, D, E, min_step, max_step):
    """Smallest positive real root of d/dt[quartic] = 4E t^3 + 3D t^2 + 2C t + B,
    clamped to [min_step, max_step].

    Matches reference compute_step_size (CvoGPU.cu:1128-1163) including its
    no-root behavior: an empty root set leaves temp_step at +inf which the
    clamp chain maps to max_step.
    """
    roots, _ = cubic_real_roots(4.0 * E, 3.0 * D, 2.0 * C, B)
    pos = jnp.where(roots > 0, roots, _BIG)
    temp_step = jnp.min(pos)
    return jnp.clip(temp_step, min_step, max_step)
