"""Per-op device timing free of per-call dispatch overhead.

For small ops the host's per-call dispatch cost swamps the kernel time.
``bench_op`` runs `chain` dependent iterations INSIDE one jitted program —
each iteration's input is perturbed by a scalar extracted from the previous
output, so XLA cannot parallelize or elide them — and returns a reduction
whose value is fetched to host (which waits for the device). Per-op time =
total / chain. tools/sweep.py times its points this way; whole-driver
timings (bench.py, chip_smoke.py) wait with ``jax.block_until_ready``.
The reference's analog is CUevent timing around a 20-iteration loop
(test/lapack/cuspotrf.c:129-141).
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp


def bench_op(op_fn, x, *, chain: int = 8, reps: int = 3,
             perturb_scale: float = 1e-30, return_out: bool = False):
    """Median seconds per op_fn(x) call, measured with forced completion.

    ``op_fn`` maps one array to one array (wrap multi-arg ops in a lambda
    closing over the other operands). Output may be any pytree; its first
    leaf is reduced for the dependency chain.

    With ``return_out`` the result is (seconds, op_fn(x)) and the op value
    comes out of the SAME chained program — saving the second full compile
    a separate jit(op_fn)(x) would cost.
    """

    @jax.jit
    def chained(x, acc0):
        def body(i, carry):
            x_i, acc = carry
            # perturb only the first leaf: keeps the dependency chain for
            # any pytree input (e.g. (re, im) pair operands)
            leaves, treedef = jax.tree_util.tree_flatten(x_i)
            leaves = [leaves[0] + acc * perturb_scale] + list(leaves[1:])
            out = op_fn(jax.tree_util.tree_unflatten(treedef, leaves))
            leaf = jax.tree_util.tree_leaves(out)[0]
            acc = jnp.sum(leaf).real.astype(jnp.float32) * 1e-30
            return x, acc

        _, acc = jax.lax.fori_loop(0, chain - 1, body, (x, acc0))
        # final iteration unrolled so the op value is a program output;
        # the perturbation keeps it on the dependency chain (acc == 0
        # numerically: perturbation is 1e-30-scaled)
        leaves, treedef = jax.tree_util.tree_flatten(x)
        leaves = [leaves[0] + acc * perturb_scale] + list(leaves[1:])
        out = op_fn(jax.tree_util.tree_unflatten(treedef, leaves))
        leaf = jax.tree_util.tree_leaves(out)[0]
        acc = jnp.sum(leaf).real.astype(jnp.float32) * 1e-30
        return acc, out

    zero = jnp.float32(0.0)
    acc, out = chained(x, zero)
    float(acc)                            # warm compile + warm path
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        acc, _ = chained(x, zero)
        float(acc)                        # host fetch ⇒ real completion
        times.append((time.perf_counter() - t0) / chain)
    dt = sorted(times)[len(times) // 2]
    return (dt, out) if return_out else dt
