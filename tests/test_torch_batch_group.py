"""The batch group (``quad_periodic_mpc_tpu_torch/parallel/batch_group.py``)
and the Newton-Schulz inverses' batch-global decisions over it, on the CPU.

The reference takes ``ns_inverse``'s trip count (``jnp.all(contractive)``)
and ``ns_inverse_bucket``'s escalated set (``lax.top_k``) and branch
(``lax.cond(n_bad <= k)``) over its global batch however it is sharded.  Here
the same inputs, split into 2 or 4 chunks rolled out in lockstep
(``mesh.run_lockstep``), must give the unsplit call's result bit for bit, and
JAX's unsplit result within test_torch_condensed.py's 1e-5.  Then the
group's own exchanges, its failure modes (a raise, an early leave, a
mismatched exchange, a member that never joins: each makes every member
raise), a member that runs past the timeout without an exchange (the group
completes), and a ``Ranks`` group over a one-rank Gloo process group."""

import socket
import sys
import threading
import time

import numpy as np
import pytest
import torch

# one intra-op thread: pytest -n workers share the cores, a thread per core in each oversubscribes
torch.set_num_threads(1)

import jax.numpy as jnp
import torch.distributed as dist

from quad_periodic_mpc_tpu.ops import linalg as j_linalg
from quad_periodic_mpc_tpu_torch.ops import linalg as t_linalg
from quad_periodic_mpc_tpu_torch.parallel import batch_group as bg
from quad_periodic_mpc_tpu_torch.parallel import mesh as mesh_lib

CPU = torch.device("cpu")
N = 24


def _spd_batch(seed, B, n=N):
    G = np.random.default_rng(seed).normal(size=(B, n, n))
    K = np.asarray(G @ np.swapaxes(G, -1, -2) + 5.0 * np.eye(n), np.float32)
    return K, np.linalg.inv(K.astype(np.float64))


def _bucket_case(case):
    """(K, X0, kwargs) of B = 16.  "tied": instances 2-9 share one K and one
    contractive seed (K^-1 x 1.4), instance 13 is jumped (x 7); k = 4 takes
    13 and 2, 3, 4 (lax.top_k's lower indices), so that over four chunks of
    four the tie straddles chunks 0-2 and chunk 2 escalates nothing.
    "nan": the same, instance 6's seed all NaN (first in the top k).
    "all_cold": zero seeds, the whole-batch branch.  "indefinite": instance
    11's seed with a negative eigenvalue, which the rescue restarts cold."""
    K, K_inv = _spd_batch(7, 16)
    X0 = np.array(K_inv, np.float32)
    kw = dict(warm_iters=1, cold_iters=14)
    if case in ("tied", "nan"):
        K[2:10], X0[2:10] = K[2], np.float32(1.4) * X0[2]
        X0[13] *= 7.0
        if case == "nan":
            X0[6] = np.nan
    elif case == "all_cold":
        X0 = np.zeros_like(X0)
        kw = dict(warm_iters=1, cold_iters=20)
    else:
        Rm = np.eye(N)
        Rm[0, 0] = -1.0
        X0[11] = (Rm @ K_inv[11]).astype(np.float32)
    return torch.as_tensor(K), torch.as_tensor(X0), kw


def _split(fn, tensors, chunks):
    """fn over ``chunks`` contiguous chunks of the tensors in lockstep, the
    results concatenated in order."""
    mesh = mesh_lib.make_mesh(devices=[CPU] * chunks)
    parts = list(zip(*(torch.tensor_split(t, chunks) for t in tensors)))
    return torch.cat(mesh_lib.run_lockstep(lambda c: fn(*c), parts, mesh))


@pytest.mark.parametrize("case", ["tied", "nan", "all_cold", "indefinite"])
def test_split_bucket_equals_unsplit(case):
    K, X0, kw = _bucket_case(case)
    whole = t_linalg.ns_inverse_bucket(K, X0, **kw)
    for chunks in (2, 4):
        split = _split(lambda k, x: t_linalg.ns_inverse_bucket(k, x, **kw), (K, X0), chunks)
        assert torch.equal(split, whole), (chunks, float((split - whole).abs().max()))
    want = np.asarray(j_linalg.ns_inverse_bucket(jnp.asarray(K.numpy()),
                                                 jnp.asarray(X0.numpy()), **kw))
    np.testing.assert_allclose(whole.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", ["tied", "nan"])
def test_escalated_set_is_lax_top_k(case):
    """The escalated set of the tied and NaN cases is lax.top_k's (13, 2, 3,
    4 and 6, 13, 2, 3), and over four chunks each gets its share in local
    indices (chunk 2 none in the tied case)."""
    import jax

    K, X0, _ = _bucket_case(case)
    r = t_linalg._inf_norm(torch.eye(N) - X0 @ K)
    top = np.asarray(jax.lax.top_k(jnp.asarray(r.numpy()), 4)[1]).tolist()
    assert top == {"tied": [13, 2, 3, 4], "nan": [6, 13, 2, 3]}[case]
    assert t_linalg._escalated(r, 4).tolist() == top
    mesh = mesh_lib.make_mesh(devices=[CPU] * 4)
    got = mesh_lib.run_lockstep(lambda x: t_linalg._escalated(x, 4).tolist(),
                                list(torch.tensor_split(r, 4)), mesh)
    assert got == [[i - 4 * c for i in top if i // 4 == c] for c in range(4)]


def test_split_ns_inverse_trip_count_is_global():
    """``ns_inverse``'s trip count over the group: instance 14's seed is
    jumped, so the whole batch takes the full ``iters`` (chunks 0-2, every
    seed of theirs contractive, would take ``warm_iters`` alone)."""
    K, K_inv = _spd_batch(9, 16)
    K, X0 = torch.as_tensor(K), torch.as_tensor(np.float32(1.05) * K_inv.astype(np.float32))
    X0[14] *= 7.0
    kw = dict(iters=12, warm_iters=2)
    whole = t_linalg.ns_inverse(K, X0=X0, **kw)
    for chunks in (2, 4):
        split = _split(lambda k, x: t_linalg.ns_inverse(k, X0=x, **kw), (K, X0), chunks)
        assert torch.equal(split, whole), chunks
    alone = t_linalg.ns_inverse(K[:4], X0=X0[:4], **kw)
    assert not torch.equal(alone, whole[:4])
    want = np.asarray(j_linalg.ns_inverse(jnp.asarray(K.numpy()), X0=jnp.asarray(X0.numpy()),
                                          **kw))
    np.testing.assert_allclose(whole.numpy(), want, atol=1e-5, rtol=0)


def _members(group, fn, n, absent=()):
    """fn(member) in n threads joined to ``group``, but for the members in
    ``absent``, whose threads never start: (results, errors)."""
    results, errors = [None] * n, [None] * n

    def work(i):
        try:
            with bg.joined(group, i) as member:
                results[i] = fn(member, i)
        except Exception as e:      # noqa: BLE001  (read back by the test)
            errors[i] = e

    threads = [threading.Thread(target=work, args=(i,)) for i in range(n) if i not in absent]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    return results, errors


def test_threads_group_exchanges():
    """gather (global order, each member's offset), sum and all over three
    members, several rounds; outside a group ``current()`` is LOCAL."""
    assert bg.current() is bg.LOCAL

    def fn(member, i):
        out = []
        for round_ in range(3):
            x = torch.arange(i + 1, dtype=torch.float32) + 10 * i + round_
            out.append((member.gather("g", x), member.sum("s", i + round_),
                        member.all("a", i != 1 or round_ != 2)))
        assert bg.current() is member
        return out

    results, errors = _members(bg.Threads(3), fn, 3)
    assert errors == [None] * 3
    for i, rounds in enumerate(results):
        for round_, ((values, offset), total, every) in enumerate(rounds):
            assert values.tolist() == [v + round_ for v in (0, 10, 11, 20, 21, 22)]
            assert offset == [0, 1, 3][i]
            assert total == 3 + 3 * round_
            assert every == (round_ != 2)
    assert bg.current() is bg.LOCAL


@pytest.mark.parametrize("fault", ["raise", "leave", "mismatch", "timeout"])
def test_group_faults_make_every_member_raise(fault, monkeypatch):
    """One member raises before its exchange, leaves without it, reaches
    another exchange, or never joins (its thread never starts, so the turn
    stands with no member running it): every other member raises
    GroupError (the last within the timeout, 2 s here) and none hangs;
    run_lockstep re-raises the member's own error first."""
    monkeypatch.setattr(bg, "TIMEOUT_S", 2.0)

    def fn(member, i):
        if i == 1:
            if fault == "raise":
                raise ValueError("chunk 1")
            if fault == "leave":
                return None
        tag = "other" if (fault == "mismatch" and i == 1) else "r"
        return member.gather(tag, torch.ones(2))

    t0 = time.perf_counter()
    _, errors = _members(bg.Threads(3), fn, 3, absent=(1,) if fault == "timeout" else ())
    assert time.perf_counter() - t0 < 10.0
    others = [e for i, e in enumerate(errors) if i != 1 or fault == "mismatch"]
    assert all(isinstance(e, bg.GroupError) for e in others), errors
    if fault == "raise":
        assert isinstance(errors[1], ValueError)
        mesh = mesh_lib.make_mesh(devices=[CPU] * 3)
        with pytest.raises(ValueError, match="chunk 1"):
            mesh_lib.run_lockstep(
                lambda c: fn(bg.current(), c), [0, 1, 2], mesh, bg.Threads(3))


@pytest.mark.parametrize("exchanges", [0, 3])
def test_running_member_is_never_timed_out(exchanges, monkeypatch):
    """Each member works 0.5 s, past the timeout (0.2 s), before its first
    exchange and between two (or through its whole run with none, as a
    stagewise chunk does) while the others wait for the turn: the group
    completes and no member raises."""
    monkeypatch.setattr(bg, "TIMEOUT_S", 0.2)

    def fn(member, i):
        time.sleep(0.5)
        for _ in range(exchanges):
            member.all("a", True)
            time.sleep(0.5 if i == 1 else 0.0)
        return i

    results, errors = _members(bg.Threads(3), fn, 3)
    assert errors == [None] * 3 and results == [0, 1, 2]


def test_threads_group_stress():
    """16 members (more than the cores) and 100 exchanges each under a
    shortened switch interval: every sum and gather equals the one computed
    from all members' parts, in every round."""
    n, rounds = 16, 100

    def fn(member, i):
        bad = 0
        for r in range(rounds):
            values, offset = member.gather("g", torch.tensor([float(i + r)]))
            bad += values.tolist() != [float(j + r) for j in range(n)] or offset != i
            bad += member.sum("s", i * r) != r * n * (n - 1) // 2
        return bad

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.perf_counter()
        results, errors = _members(bg.Threads(n), fn, n)
    finally:
        sys.setswitchinterval(interval)
    assert errors == [None] * n and results == [0] * n
    assert time.perf_counter() - t0 < 30.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_ranks_group_over_gloo():
    """A Ranks group of two threads in a one-rank Gloo process group: the
    bucket's decisions through the group's all_gathers (two per gather),
    bit for bit the unsplit call."""
    K, X0, kw = _bucket_case("tied")
    whole = t_linalg.ns_inverse_bucket(K, X0, **kw)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = mesh_lib.make_mesh(devices=[CPU] * 2)
        parts = list(zip(torch.tensor_split(K, 2), torch.tensor_split(X0, 2)))
        group = bg.Ranks(2)
        split = torch.cat(mesh_lib.run_lockstep(
            lambda c: t_linalg.ns_inverse_bucket(*c, **kw), parts, mesh, group))
        assert group.collectives == 2
        group = bg.Ranks(1)
        ((total, every),), errors = _members(
            group, lambda m, i: (m.sum("s", 5), m.all("a", True)), 1)
        assert errors == [None] and (total, every) == (5, True)
        assert group.collectives == 2
    finally:
        dist.destroy_process_group()
    assert torch.equal(split, whole)
