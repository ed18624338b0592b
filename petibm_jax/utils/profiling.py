"""Per-phase device-time breakdown of the jitted time step.

The reference delimits every phase of the step with PETSc log stages and
dumps -log_view tables at each save (reference: navierstokes.cpp:99-199,
io.cpp:274 writePetscLog).  A jitted XLA step is one fused program, so
phase times cannot be read from inside it.  Instead the profiler builds
one jitted *prefix program* per phase — phases 0..i chained inside a
single XLA program, returning a scalar probe data-dependent on phase i's
output — and times `device_get(P_i(state))` from a fixed developed
snapshot.  The difference median(T_i) - median(T_{i-1}) is then phase
i's pure device time: dispatch overhead and the host/device round trip
are identical for every prefix and cancel.

Why not dispatch the phases separately and sync after phase i?  Each
program dispatch and sync costs host time comparable to or larger than a
small phase, and it would land in every difference.  A null program
(probe of the input state) provides the round-trip baseline subtracted
from phase 0.  Every timing ends in a value transfer
(`float(jax.device_get(...))`) of a probe that depends on the phase.

There is also ``trace()`` for a raw jax-profiler trace of the production
fused step (for xprof/tensorboard), which XLA-fuses across phases and is
the number to compare with bench.py.
"""

from __future__ import annotations

import time

import jax


def profile_stages(solver, steps: int = 10, warmup: int = 3,
                   path: str | None = None, repeat: int = 8) -> dict:
    """Prefix-program phase breakdown; returns {phase: ms} plus
    "_total" (last prefix minus the null baseline — the step's device
    time) and "_fused" (the production one-program step + sync, for
    comparison).  ``steps`` = timing trials per prefix (medians are
    reported).  Writes a stage table to ``path``.

    ``repeat``: each prefix runs its phase chain this many times inside
    one program (a lax.scan whose input state takes a ~1e-35 perturbation
    from the previous repeat's probe, so XLA can neither CSE nor hoist
    the loop-invariant body) and the measured difference is divided back.
    Sub-millisecond phases would otherwise drown in the host round
    trip's jitter."""
    import numpy as np

    phases = solver._profile_phases()

    def _anchor(tree, probe):
        """Fold a reduction over EVERY carried leaf into the returned
        scalar: without this, XLA dead-code-eliminates any phase work
        outside the probe's dependency cone (e.g. the update phase's
        ghost refresh consumed only by the *next* step), silently
        misattributing or dropping device time from the phase split."""
        import jax.numpy as jnp

        acc = jnp.asarray(probe, jnp.float32).astype(jnp.float32)
        for leaf in jax.tree_util.tree_leaves(tree):
            acc = acc + jnp.sum(leaf).astype(jnp.float32)
        return acc

    def make_prefix(i):
        import jax.numpy as jnp

        def chain(state):
            ctx = {"state": state}
            probe = None
            for _, fn in phases[:i + 1]:
                ctx, probe = fn(ctx)
            return _anchor(ctx, probe)

        @jax.jit
        def P(state):
            def one(feed, _):
                # feed the previous repeat's probe back at ~1e-35 scale:
                # numerically a no-op, but it makes the body's input
                # loop-variant so the scan really executes `repeat` times
                leaves, treedef = jax.tree_util.tree_flatten(state)
                leaves = [l + (feed * 1e-35).astype(l.dtype)
                          for l in leaves]
                st = jax.tree_util.tree_unflatten(treedef, leaves)
                return chain(st), None

            feed, _ = jax.lax.scan(one, jnp.asarray(0.0, jnp.float32),
                                   None, length=repeat)
            return feed

        return P

    @jax.jit
    def null(state):
        # the null baseline runs the SAME repeat-amplified anchor scan as
        # the prefixes (minus any phase work): med[0] = dispatch +
        # repeat*anchor, so the anchor-reduction cost cancels out of
        # phase 0's difference instead of inflating it by
        # (repeat-1)/repeat of a whole-state reduction
        import jax.numpy as jnp

        def one(feed, _):
            leaves, treedef = jax.tree_util.tree_flatten(state)
            leaves = [l + (feed * 1e-35).astype(l.dtype) for l in leaves]
            st = jax.tree_util.tree_unflatten(treedef, leaves)
            return _anchor(st, 0.0), None

        feed, _ = jax.lax.scan(one, jnp.asarray(0.0, jnp.float32),
                               None, length=repeat)
        return feed

    prefix = [make_prefix(i) for i in range(len(phases))]

    # developed snapshot (production steps), then compile every prefix
    state = solver.state
    for _ in range(max(1, warmup)):
        state, stats = solver._step_fn(state)
    _sync_stats(stats)
    float(jax.device_get(null(state)))
    for P in prefix:
        float(jax.device_get(P(state)))

    trials = [[] for _ in range(len(prefix) + 1)]
    fns = [null] + prefix
    for _ in range(max(3, steps)):
        for i, P in enumerate(fns):
            t0 = time.perf_counter()
            float(jax.device_get(P(state)))
            trials[i].append(time.perf_counter() - t0)
    med = [float(np.median(t)) * 1e3 for t in trials]

    result = {}
    for k, (name, _) in enumerate(phases):
        result[name] = max(0.0, med[k + 1] - med[k]) / repeat
    result["_total"] = max(0.0, med[-1] - med[0]) / repeat

    # the production fused step for comparison
    fused_state = state
    for _ in range(max(1, warmup)):
        fused_state, stats = solver._step_fn(fused_state)
    _sync_stats(stats)
    t0 = time.perf_counter()
    n_fused = max(3, steps)
    for _ in range(n_fused):
        fused_state, stats = solver._step_fn(fused_state)
        _sync_stats(stats)
    result["_fused"] = (time.perf_counter() - t0) / n_fused * 1e3

    if path:
        _write_table(path, result, steps)
    return result


def _sync_stats(stats) -> None:
    leaf = next(v for k, v in sorted(stats.items()) if hasattr(v, "ravel"))
    float(jax.device_get(leaf.ravel()[0]))


def _write_table(path: str, result: dict, steps: int) -> None:
    phases = {k: v for k, v in result.items() if not k.startswith("_")}
    total = max(result.get("_total", 0.0), 1e-12)
    lines = [
        "stage breakdown (prefix-program medians over "
        f"{steps} trials; round trip and dispatch overhead cancel)",
        f"{'stage':>16s} {'ms/step':>10s} {'%':>6s}",
    ]
    for name, ms in phases.items():
        lines.append(f"{name:>16s} {ms:10.4f} {100 * ms / total:6.1f}")
    lines.append(f"{'total (device)':>16s} {result['_total']:10.4f}")
    lines.append(f"{'fused step':>16s} {result['_fused']:10.4f}"
                 "   (production one-program step + sync)")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def trace(solver, out_dir: str, steps: int = 20) -> None:
    """jax-profiler trace of the production step (xprof/tensorboard)."""
    state = solver.state
    state, stats = solver._step_fn(state)  # compile outside the trace
    _sync_stats(stats)
    with jax.profiler.trace(out_dir):
        for _ in range(steps):
            state, stats = solver._step_fn(state)
        _sync_stats(stats)
