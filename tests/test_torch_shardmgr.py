"""The port's shard manager (``semadb_tpu_torch/cluster/shardmgr.py``) on the
CPU: the idle cleanup against requests in flight.

``test_shardmgr_cleanup_race_with_inflight_request`` is the JAX package's
``tests/test_cluster.py`` test of the same name, run against the port's
manager. ``test_overlapping_requests_close_a_shard_once`` pins the
interleaving behind it: two requests that overlap on one shard each arm an
idle timer on their way out; where the second did not cancel the first,
both fired, and the second cleanup closed the shard again while the first
was still closing it (on the native store, a write through a closed
handle).

Run as a script, the file loops T1's body under CPU load against either
manager and counts the closes of each shard (a crash ends the process):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_shardmgr.py {port,jax} ROUNDS BUSY_LOOPS SECONDS
"""

import collections
import os
import subprocess
import sys
import tempfile
import threading
import time

import torch

from semadb_tpu_torch.cluster.shardmgr import ShardManager
from semadb_tpu_torch.models import Collection, IndexSchema, UserPlan
from semadb_tpu_torch.shard.shard import Shard

CPU = torch.device("cpu")


def _collection():
    return Collection(user_id="u", id="c", index_schema=IndexSchema.from_dict({}), user_plan=UserPlan())


def test_shardmgr_cleanup_race_with_inflight_request(tmp_path):
    """A cleanup timer that fired but lost the race to a new request must
    not close the shard under it: _cleanup re-checks in_use under the
    manager lock (shardmgr.go's RLock-vs-cleanup discipline)."""
    col = _collection()
    mgr = ShardManager(str(tmp_path), CPU, shard_timeout=0.01)
    mgr.do_with_shard(col, "s1", lambda sh: sh.point_count())
    errors = []
    _hammer(mgr, col, errors)
    assert not errors, errors
    mgr.unload_all()


def test_overlapping_requests_close_a_shard_once(tmp_path, monkeypatch):
    """Request A holds the shard while B waits for it; both leave, each
    arming the idle timer. The shard is closed once, by one cleanup, and no
    timer thread raises. The close is slow (as a compaction is) and counted;
    a second close of the same shard is counted and not run."""
    closes = collections.Counter()
    close = Shard.close

    def slow_close(shard):
        closes[id(shard)] += 1
        if closes[id(shard)] == 1:
            time.sleep(0.05)
            close(shard)

    monkeypatch.setattr(Shard, "close", slow_close)
    raised = []
    monkeypatch.setattr(threading, "excepthook", lambda args: raised.append(args.exc_value))
    col = _collection()
    mgr = ShardManager(str(tmp_path), CPU, shard_timeout=0.2)
    a_in, a_go = threading.Event(), threading.Event()

    def use_a(sh):
        a_in.set()
        a_go.wait()
        return sh.point_count()

    ta = threading.Thread(target=mgr.do_with_shard, args=(col, "s1", use_a))
    ta.start()
    a_in.wait()
    tb = threading.Thread(target=mgr.do_with_shard, args=(col, "s1", lambda sh: sh.point_count()))
    tb.start()
    time.sleep(0.05)  # B holds the entry and waits for the shard's lock
    a_go.set()
    ta.join()
    tb.join()
    time.sleep(0.2 + 0.4)  # both timers' time, and the close
    assert list(closes.values()) == [1] and not raised, (dict(closes), raised)
    assert mgr.do_with_shard(col, "s1", lambda sh: sh.point_count()) == 0  # loads anew
    mgr.unload_all()


def _hammer(mgr, col, errors):
    """T1's body: 3 threads, 60 uses each, 4 ms a use."""
    def run():
        try:
            for _ in range(60):
                def use(sh):
                    n = sh.point_count()
                    time.sleep(0.004)
                    return n
                mgr.do_with_shard(col, "s1", use)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def stress(manager: str, rounds: int, busy: int, seconds: float) -> dict:
    """T1's body for up to ``rounds`` rounds or ``seconds``, each round on a
    fresh manager (shard timeout 0.01 s) over a temporary directory, with
    ``busy`` busy-looping processes beside it; counts the rounds, the
    rounds whose requests raised, and the shards closed more than once."""
    if manager == "jax":
        from semadb_tpu.cluster.shardmgr import ShardManager as JaxManager
        from semadb_tpu.models import Collection as JaxCollection, IndexSchema as JaxSchema, UserPlan as JaxPlan
        from semadb_tpu.shard.shard import Shard as JaxShard

        def make(root):
            return JaxManager(root, shard_timeout=0.01)
        collection = JaxCollection(user_id="u", id="c", index_schema=JaxSchema.from_dict({}), user_plan=JaxPlan())
        shard_cls = JaxShard
    else:
        def make(root):
            return ShardManager(root, CPU, shard_timeout=0.01)
        collection, shard_cls = _collection(), Shard
    closes = collections.Counter()
    close = shard_cls.close

    def counted(shard):
        closes[id(shard)] += 1
        return close(shard)

    shard_cls.close = counted
    # Busy loops that stop when this process ends, however it ends
    spin = f"import os\nwhile os.getppid() == {os.getpid()}: pass"
    loops = [subprocess.Popen([sys.executable, "-c", spin]) for _ in range(busy)]
    out = {"manager": manager, "busy_loops": busy, "rounds": 0, "rounds_with_errors": 0, "closed_twice": 0}
    t0 = time.perf_counter()
    try:
        while out["rounds"] < rounds and time.perf_counter() - t0 < seconds:
            closes.clear()
            with tempfile.TemporaryDirectory() as root:
                mgr = make(root)
                mgr.do_with_shard(collection, "s1", lambda sh: sh.point_count())
                errors = []
                _hammer(mgr, collection, errors)
                time.sleep(0.05)
                mgr.unload_all()
                time.sleep(0.02)
            out["rounds"] += 1
            out["rounds_with_errors"] += bool(errors)
            out["closed_twice"] += sum(n > 1 for n in closes.values())
            print(f"round {out['rounds']}: {dict(closes)} errors {errors[:1]}", flush=True)
    finally:
        for p in loops:
            p.kill()
            p.wait()
        shard_cls.close = close
    out["seconds"] = round(time.perf_counter() - t0, 1)
    return out


if __name__ == "__main__":
    print(stress(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), float(sys.argv[4])), flush=True)
