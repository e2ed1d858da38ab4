"""The port's multi-node cluster on one machine: the counterpart of ``run_cluster.sh``.

Starts one ``python -m semadb_tpu_torch.main --config <yaml> --device <device>``
process per config, waits until every node answers its HTTP ping, and stops
them all on exit. By default the configs are the JAX system's three-node
cluster, ``config/serverA.yaml``, ``serverB.yaml`` and ``serverC.yaml``, as
published: each is copied under the root directory with only its
``rootDir`` rewritten to ``<root>/<config name>``. A port that another
process holds is rewritten to a free one, in every config that names it
(the servers lists included), and logged; ``--free-ports`` rewrites every
port. ``--only-started`` cuts each config's servers list to the nodes this
call starts (``serverA.yaml`` alone then forms a one-node cluster, whose
shards a later start of all three re-homes by the startup sync).

Run from the root of a checkout:

    python -m semadb_tpu_torch.tools.run_cluster [--root DIR] [--device cuda] [config ...]

It serves until interrupted, and exits non-zero if a node process exits
before that. A node that cannot reach its device exits at once (``main.py``
refuses ``--device cuda`` without CUDA), and so does this command.
"""

from __future__ import annotations

import argparse
import ast
import os
import re
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIGS = tuple(os.path.join(REPO, "config", f"server{n}.yaml") for n in "ABC")
PING = "/v2/ping"
LAUNCHES = "kernel launches: "


def _port_taken(port: int) -> bool:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.bind(("", port))
        except OSError:
            return True
    return False


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("", 0))
        return s.getsockname()[1]


@dataclass
class Node:
    """One node process: its config's name, the rewritten config, its
    addresses, root directory and log file."""

    name: str
    config: str
    http: str  # base URL, http://localhost:<port>
    rpc: str  # host:port, as the servers lists name it
    root: str
    log: str
    proc: Optional[subprocess.Popen] = None

    def log_tail(self, lines: int = 40) -> str:
        with open(self.log, errors="replace") as f:
            return "".join(f.readlines()[-lines:])

    def launches(self) -> Dict[str, int]:
        """The kernel launches the node logged at its last shutdown (main.py)."""
        found = None
        with open(self.log, errors="replace") as f:
            for line in f:
                at = line.find(LAUNCHES)
                if at >= 0:
                    found = ast.literal_eval(line[at + len(LAUNCHES):].strip())
        if found is None:
            raise RuntimeError(f"node {self.name} logged no kernel launches:\n{self.log_tail()}")
        return found


@dataclass
class Cluster:
    """Node processes started together; a context manager that stops them."""

    nodes: List[Node]
    rewritten_ports: Dict[int, int] = field(default_factory=dict)  # published port -> the port used

    def __enter__(self) -> "Cluster":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def check(self) -> None:
        """Raise if a node process has exited."""
        for n in self.nodes:
            if n.proc is not None and n.proc.poll() is not None:
                raise RuntimeError(f"node {n.name} exited with code {n.proc.returncode}:\n{n.log_tail()}")

    def stop(self, timeout: float = 60.0) -> List[int]:
        """SIGTERM every node (each shuts its servers and closes its shards),
        kill what is left after ``timeout`` s; returns the exit codes."""
        live = [n for n in self.nodes if n.proc is not None and n.proc.poll() is None]
        for n in live:
            n.proc.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + timeout
        for n in live:
            try:
                n.proc.wait(max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                n.proc.kill()
                n.proc.wait()
        return [n.proc.returncode for n in self.nodes if n.proc is not None]


def prepare(
    configs: Sequence[str], root: str, free_ports: bool = False, only_started: bool = False
) -> Cluster:
    """Write each config under ``root`` with ``rootDir`` = ``<root>/<name>``
    and its ports kept, or rewritten where taken (every one with
    ``free_ports``); nothing is started."""
    import yaml

    raw = []
    for path in configs:
        with open(path) as f:
            raw.append((os.path.splitext(os.path.basename(path))[0], yaml.safe_load(f) or {}))
    ports: Dict[int, int] = {}
    for _, d in raw:
        for port in (int(d["clusterNode"]["rpcPort"]), int(d["httpApi"]["httpPort"])):
            if port not in ports:
                ports[port] = _free_port() if free_ports or _port_taken(port) else port

    def moved(addr: str) -> str:
        host, port = addr.rsplit(":", 1)
        return f"{host}:{ports.get(int(port), int(port))}"

    os.makedirs(root, exist_ok=True)
    nodes = []
    started = [moved(f"{d['clusterNode'].get('rpcHost', 'localhost')}:{d['clusterNode']['rpcPort']}") for _, d in raw]
    for (name, d), rpc in zip(raw, started):
        cn, http = d["clusterNode"], d["httpApi"]
        cn["rootDir"] = os.path.join(root, name)
        cn["rpcPort"] = ports[int(cn["rpcPort"])]
        http["httpPort"] = ports[int(http["httpPort"])]
        cn["servers"] = list(started) if only_started else [moved(s) for s in cn.get("servers", [])]
        path = os.path.join(root, f"{name}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(d, f, sort_keys=False)
        nodes.append(Node(name, path, f"http://localhost:{http['httpPort']}", rpc, cn["rootDir"],
                          os.path.join(root, f"{name}.log")))
    return Cluster(nodes, {p: q for p, q in ports.items() if p != q})


def launch(
    cluster: Cluster, device: str = "cuda", timeout: float = 300.0, names: Optional[Sequence[str]] = None
) -> Cluster:
    """Start the nodes of ``cluster`` named in ``names`` (default: every one)
    at once and wait for their pings; on a node that exits or does not
    answer within ``timeout`` s, stop every node and raise. A node whose
    startup sync ships shards to others is started after them, so that its
    RPC calls find them serving."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    todo = [n for n in cluster.nodes if names is None or n.name in names]
    try:
        for n in todo:
            with open(n.log, "ab") as log:
                n.proc = subprocess.Popen(
                    [sys.executable, "-m", "semadb_tpu_torch.main", "--config", n.config, "--device", device],
                    cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT,
                )
        deadline = time.monotonic() + timeout
        for n in todo:
            while not _pings(n):
                cluster.check()
                if time.monotonic() > deadline:
                    raise RuntimeError(f"node {n.name} did not answer {PING} in {timeout} s:\n{n.log_tail()}")
                time.sleep(0.2)
    except BaseException:
        cluster.stop()
        raise
    return cluster


def start(
    configs: Optional[Sequence[str]] = None, root: Optional[str] = None, device: str = "cuda",
    free_ports: bool = False, only_started: bool = False, timeout: float = 300.0,
) -> Cluster:
    """:func:`prepare` then :func:`launch`: a running cluster of ``configs``
    (default ``CONFIGS``) under ``root`` (default: a temporary directory)."""
    root = root or tempfile.mkdtemp(prefix="semadb_cluster_")
    return launch(prepare(configs or CONFIGS, root, free_ports, only_started), device, timeout)


def _pings(n: Node) -> bool:
    try:
        with urllib.request.urlopen(n.http + PING, timeout=2) as r:
            return r.status == 200
    except OSError:
        return False


_SYNC = re.compile(r"^(\S+ \S+) .*(rpc serving on|startup sync: (\{.*\}))")


def startup_sync(n: Node) -> List[tuple]:
    """Each startup sync in a node's log, oldest first: (its stats, the seconds
    from the RPC server's start to the sync's end, by the log's clock)."""
    out, since = [], None
    with open(n.log, errors="replace") as f:
        for line in f:
            m = _SYNC.match(line)
            if not m:
                continue
            t = time.mktime(time.strptime(m.group(1).split(",")[0], "%Y-%m-%d %H:%M:%S"))
            t += int(m.group(1).split(",")[1]) / 1000.0
            if m.group(3) is None:
                since = t
            elif since is not None:
                out.append((ast.literal_eval(m.group(3)), t - since))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("configs", nargs="*", help="node configs (default: config/server{A,B,C}.yaml)")
    parser.add_argument("--root", default="", help="root of the nodes' directories (default: a temporary one)")
    parser.add_argument("--device", default="cuda", help="torch device of every node")
    parser.add_argument("--free-ports", action="store_true", help="rewrite every port to a free one")
    parser.add_argument("--only-started", action="store_true", help="cut the servers lists to the nodes started")
    args = parser.parse_args(argv)
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    with start(args.configs, args.root or None, args.device, args.free_ports, args.only_started) as cluster:
        for old, new in cluster.rewritten_ports.items():
            print(f"port {old} rewritten to {new}", flush=True)
        for n in cluster.nodes:
            print(f"{n.name}: http {n.http}, rpc {n.rpc}, root {n.root}, log {n.log}", flush=True)
        while not stop.wait(0.5):
            try:
                cluster.check()
            except RuntimeError as e:
                print(e, file=sys.stderr, flush=True)
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
