"""JAX's default PRNG (threefry2x32, partitionable) in NumPy, for the
port's tests.

The bit engines' tests feed the JAX package's own draws to the port. A
jitted JAX draw helper costs about a second of compile per new shape, so
the keys, splits, fold-ins and uniforms of ``jax.random`` are recomputed
here bit for bit: every draw-exact test of ``tests/test_torch_clifford.py``,
``test_torch_qec.py`` and ``test_torch_qec_circuit.py`` feeds these values
to the port and JAX's keys to the JAX function, so a wrong bit fails it.
Keys are ``(2,)`` uint32 arrays, or ``(..., 2)`` batches.

The MPS family's tests (``test_torch_mps.py``, ``test_torch_mps_dynamics
.py``) add Gumbel draws (``jax.random.categorical``), the MPS key
schedules, draw tables that let a JAX body be jitted and vmapped on given
draws (``jax_keyed_table``, ``jax_chained_table``), and the port-side
recorders of draws and their margins.
"""

import contextlib

import numpy as np

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds), elementwise over uint32."""
    with np.errstate(over="ignore"):
        ks = (np.asarray(k1, np.uint32), np.asarray(k2, np.uint32),
              np.asarray(k1, np.uint32) ^ np.asarray(k2, np.uint32)
              ^ np.uint32(0x1BD11BDA))
        x = [np.asarray(x1, np.uint32) + ks[0],
             np.asarray(x2, np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROT[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = (x[1] << np.uint32(r)) | (x[1] >> np.uint32(32 - r))
                x[1] = x[0] ^ x[1]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off (JAX's default):
    the seed is cut to its low 32 bits, the high word is 0."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def key_from_seed(seed: int) -> np.ndarray:
    """The JAX package's ``utils.seeding.key_from_seed``: the low word
    as the key, the high word folded in."""
    k = key(seed)
    return fold_in(k, int(seed) >> 32) if int(seed) >> 32 else k


def _iota(n: int):
    idx = np.arange(n, dtype=np.uint64)
    return (idx >> np.uint64(32)).astype(np.uint32), \
        (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def split(k: np.ndarray, n: int = 2) -> np.ndarray:
    """``jax.random.split(k, n)`` -> (n, 2); batched over ``k[..., 2]``."""
    hi, lo = _iota(n)
    b1, b2 = _threefry(k[..., :1], k[..., 1:], hi, lo)
    return np.stack([b1, b2], axis=-1)


def fold_in(k: np.ndarray, data) -> np.ndarray:
    """``jax.random.fold_in(k, data)``; batched over ``k[..., 2]``."""
    b1, b2 = _threefry(k[..., 0], k[..., 1], np.uint32(0),
                       np.uint32(int(data)))
    return np.stack([b1, b2], axis=-1)


def bits(k: np.ndarray, n: int) -> np.ndarray:
    """32-bit random words ``(..., n)`` of ``jax.random.bits``."""
    hi, lo = _iota(n)
    b1, b2 = _threefry(k[..., :1], k[..., 1:], hi, lo)
    return b1 ^ b2


def uniform(k: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.uniform(k, (n,))`` float32; batched over keys."""
    w = (bits(k, n) >> np.uint32(9)) | np.uint32(0x3F800000)
    return np.maximum(w.view(np.float32) - np.float32(1), np.float32(0))


def bernoulli(k: np.ndarray, n: int, p: float = 0.5) -> np.ndarray:
    """``jax.random.bernoulli(k, p, (n,))``."""
    return uniform(k, n) < np.float32(p)


def gumbel(k: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.gumbel(k, (n,))`` float32 (``mode="low"``: one
    uniform on [tiny, 1) per value); batched over keys. JAX's draws are
    prefix-stable, so ``gumbel(k, n)[..., :m]`` is the draw of shape
    ``(m,)`` (``jax.random.categorical`` over m branches adds it to the
    log-weights and takes the argmax)."""
    tiny = np.finfo(np.float32).tiny
    w = (bits(k, n) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = w.view(np.float32) - np.float32(1)
    u = np.maximum(np.float32(tiny),
                   floats * np.float32(1.0 - tiny) + np.float32(tiny))
    return -np.log(-np.log(u))


def cascade_uniforms(k: np.ndarray, n: int) -> np.ndarray:
    """The MPS sampling cascade's draws: for each of n sites ``k, sub =
    split(k)`` and one ``uniform(sub)``. ``k`` (S, 2) -> (S, n)."""
    out = np.empty(k.shape[:-1] + (n,), np.float32)
    for i in range(n):
        ks = split(k)
        k, sub = ks[..., 0, :], ks[..., 1, :]
        out[..., i] = uniform(sub, 1)[..., 0]
    return out


def mps_master_key(seed) -> np.ndarray:
    """The key ``MPSSimulator`` forks from ``seed``:
    ``PRNGKey(default_rng(seed).integers(0, 2**63))``."""
    return key(int(np.random.default_rng(seed).integers(0, 2 ** 63)))


def mps_run_uniforms(seed, shots: int, n: int) -> np.ndarray:
    """``MPSSimulator.run``'s cascade draws (shots, n)."""
    return cascade_uniforms(split(mps_master_key(seed), shots), n)


def mps_noisy_draws(seed, shots: int, branches, n: int):
    """``MPSSimulator.run_with_noise``'s draws: each shot's key splits
    into a trajectory key (split again into one key per Kraus draw) and a
    cascade key. -> (gumbels (shots, draws, width), uniforms (shots, n))."""
    ks = split(split(mps_master_key(seed), shots))     # (shots, 2, 2)
    return (_draw_gumbels(ks[:, 0], branches),
            cascade_uniforms(ks[:, 1], n))


def mps_monitored_gumbels(seed, n_traj: int, branches) -> np.ndarray:
    """``monitored_trajectories``' draws: one key per trajectory, split
    into one key per projector or Kraus draw."""
    return _draw_gumbels(split(mps_master_key(seed), n_traj), branches)


def _draw_gumbels(traj_keys: np.ndarray, branches) -> np.ndarray:
    width = max(branches, default=1)
    if not branches:
        return np.zeros(traj_keys.shape[:-1] + (0, width), np.float32)
    return gumbel(split(traj_keys, len(branches)), width)


def shadow_uniforms(seed, n_snapshots: int, n: int) -> np.ndarray:
    """``collect_shadows(engine="mps")``'s cascade draws: the bases come
    first from the NumPy stream, then the master key."""
    rng = np.random.default_rng(seed)
    rng.integers(0, 3, size=(n_snapshots, n))
    master = key(int(rng.integers(0, 2 ** 63)))
    return cascade_uniforms(split(master, n_snapshots), n)


def lindblad_mps_gumbels(seed: int, n_traj: int, n_steps: int,
                         n_jump: int) -> np.ndarray:
    """``MPSLindbladSimulator.evolve``'s jump draws: ``split(PRNGKey(seed),
    T)``, each trajectory key split into ``n_steps * n_jump`` keys.
    -> (T, n_steps, n_jump, 2)."""
    ks = split(split(key(seed), n_traj), n_steps * n_jump)
    return gumbel(ks, 2).reshape(n_traj, n_steps, n_jump, 2)


@contextlib.contextmanager
def port_draws(log: list):
    """Record the port's MPS Kraus and projector draws: each batched draw
    appends ``(branch (B,), margin (B,))``, the margin being the gap
    between the two largest ``log w + g`` of a row (a draw whose margin
    is below float32 rounding may go either way between two
    implementations)."""
    import torch

    from quantum_simulator_tpu_torch import mps as tm

    real = tm._BatchMPS.apply_kraus_1q

    def recording(self, site, kstack, gumbel):
        self.move_center_to(site)
        t = self.tensors[site]
        w = torch.matmul(kstack[None, :, None], t[:, None]).abs().square(
            ).sum((2, 3, 4))
        top = torch.topk(torch.log(w.clamp_min(1e-30)) + gumbel,
                         min(2, w.shape[1]), dim=1).values
        margin = (top[:, 0] - top[:, -1]) if w.shape[1] > 1 else \
            torch.full_like(top[:, 0], np.inf)
        m = real(self, site, kstack, gumbel)
        log.append((m.cpu().numpy(), margin.cpu().numpy()))
        return m

    tm._BatchMPS.apply_kraus_1q = recording
    try:
        yield
    finally:
        tm._BatchMPS.apply_kraus_1q = real


def cascade_margins(tensors, uniforms: np.ndarray, bits: np.ndarray):
    """``|u - P(0 | earlier bits)|`` of each (shot, site) of the MPS
    cascade, replayed along ``bits`` over (l, 2, r) or (S, l, 2, r)
    right-canonical tensors."""
    import torch

    S, n = uniforms.shape
    t0 = tensors[0]
    v = torch.zeros((S, 1), dtype=t0.dtype, device=t0.device)
    v[:, 0] = 1.0
    out = np.empty((S, n))
    for i, t in enumerate(tensors):
        y = (torch.einsum("sl,lpr->spr", v, t) if t.dim() == 3
             else torch.einsum("sl,slpr->spr", v, t))
        p = y.abs().square().sum(-1)
        pr0 = (p[:, 0] / p.sum(-1).clamp_min(1e-30)).cpu().numpy()
        out[:, i] = np.abs(uniforms[:, i] - pr0)
        b = torch.from_numpy(bits[:, i].astype(np.int64)).to(t0.device)
        w = y[torch.arange(S), b]
        v = w / w.abs().square().sum(-1, keepdim=True).clamp_min(
            1e-30).sqrt()
    return out


def assert_draw_exact(got: np.ndarray, want: np.ndarray,
                      margins: np.ndarray, tol: float = 1e-5):
    """Per-row draw sequences equal, except that a row may part at a draw
    whose margin is below ``tol``; such draws are under 1 % of all."""
    got, want, margins = (np.asarray(a) for a in (got, want, margins))
    assert got.shape == want.shape
    near = margins < tol
    assert near.sum() <= 0.01 * near.size, (
        f"{near.sum()} of {near.size} draws within {tol} of a tie")
    for r in range(got.shape[0]):
        diff = np.nonzero(got[r] != want[r])[0]
        if diff.size:
            assert near[r, diff[0]], (
                f"row {r} parts at draw {diff[0]} with margin "
                f"{margins[r, diff[0]]}")


@contextlib.contextmanager
def _patched_random(**fns):
    import jax

    real = {name: getattr(jax.random, name) for name in fns}
    try:
        for name, fn in fns.items():
            setattr(jax.random, name, fn)
        yield
    finally:
        for name, fn in real.items():
            setattr(jax.random, name, fn)


def jax_keyed_table(gumbels, recorded: list | None = None):
    """Trace a JAX body whose draws are ``categorical`` over keys from
    ``jax.random.split(key, n)``, reading the draws from a table: split
    returns keys that carry their index, and ``categorical(k, logits)``
    is ``argmax(logits + gumbels[k[1], :m])`` (``gumbels`` a (n, width)
    array, traced or not). Each drawn index is appended to ``recorded``
    (tracers inside a trace). With the replica's Gumbel rows in the
    table this is JAX's draw, and the body can be jitted and vmapped."""
    import jax.numpy as jnp

    def split_(k, num=2):
        return jnp.stack([jnp.zeros(num, jnp.uint32),
                          jnp.arange(num, dtype=jnp.uint32)], axis=-1)

    def categorical_(k, logits, axis=-1):
        m = jnp.argmax(logits + gumbels[k[1], :logits.shape[-1]], axis=axis)
        if recorded is not None:
            recorded.append(m)
        return m

    return _patched_random(split=split_, categorical=categorical_)


def jax_chained_table(uniforms):
    """Trace a JAX body that draws ``k, sub = split(k)`` then
    ``uniform(sub)`` per step (the MPS cascade), reading step i's uniform
    from ``uniforms[i]``: split(k) returns ``(k + (0, 1), k)`` from a
    start key of zeros, so step i's ``sub`` carries i."""
    import jax.numpy as jnp

    def split_(k, num=2):
        k = jnp.asarray(k, jnp.uint32)
        return jnp.stack([k + jnp.array([0, 1], jnp.uint32), k])

    def uniform_(k, shape=(), dtype=None, minval=0.0, maxval=1.0):
        return uniforms[k[1]]

    return _patched_random(split=split_, uniform=uniform_)


def mesh_trajectory_gumbels(seeds, n_draws: int, width: int) -> np.ndarray:
    """The sharded trajectory body's draws (``parallel/distributed.py``:
    ``keys = split(key, total_draws)``, one ``categorical`` per key) for
    trajectory keys ``key_from_seed(s)``. -> (T, n_draws, width)."""
    keys = np.stack([key_from_seed(int(s)) for s in seeds])
    return gumbel(split(keys, n_draws), width)
