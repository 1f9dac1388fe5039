"""The port's RPC plane and node agents (``tosem_tpu_torch/cluster/rpc.py``,
``cluster/node.py``): ``tests/test_rpc_node.py`` run against the port
(its multi-process agent legs keep their ``slow`` mark), the wire held
between the packages both ways (a port client calls a JAX package server
and the other way round, on the same frames), and the import discipline
of the processes that never touch the card: node agents, routers and the
replica worker's module load neither torch, numpy nor JAX.
"""
import os
import subprocess
import sys
import threading

import pytest

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS_DIR)

from tosem_tpu_torch.cluster import RemoteNode, RpcClient, RpcError, RpcServer


# module-level so spawn-mode agent workers can import them
def square(x):
    return x * x


def boom(_x):
    raise ValueError("synthetic remote failure")


class MathService:
    def add(self, a, b):
        return a + b

    def fail(self):
        raise RuntimeError("service error")

    def _private(self):
        return "hidden"


class TestRpc:
    def test_dict_and_object_handlers(self):
        srv = RpcServer({"echo": lambda x: x})
        try:
            with RpcClient(srv.address) as c:
                assert c.call("echo", {"deep": [1, 2, 3]}) == \
                    {"deep": [1, 2, 3]}
        finally:
            srv.shutdown()
        srv2 = RpcServer(MathService())
        try:
            with RpcClient(srv2.address) as c:
                assert c.add(20, 22) == 42          # attribute sugar
                with pytest.raises(RpcError, match="service error") as ei:
                    c.fail()
                assert "RuntimeError" in ei.value.remote_traceback
                with pytest.raises(RpcError, match="no such RPC method"):
                    c.call("_private")
        finally:
            srv2.shutdown()

    def test_many_sequential_and_concurrent_calls(self):
        srv = RpcServer({"inc": lambda x: x + 1})
        try:
            c = RpcClient(srv.address)
            for i in range(200):
                assert c.call("inc", i) == i + 1
            c.close()
            # concurrent clients over separate connections
            errs = []

            def worker():
                try:
                    with RpcClient(srv.address) as cc:
                        for i in range(50):
                            assert cc.call("inc", i) == i + 1
                except Exception as e:
                    errs.append(e)
            ts = [threading.Thread(target=worker) for _ in range(4)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in ts)
            assert not errs
        finally:
            srv.shutdown()

    def test_dead_server_raises_connection_error(self):
        srv = RpcServer({"ping": lambda: "pong"})
        c = RpcClient(srv.address)
        assert c.call("ping") == "pong"
        srv.shutdown()
        with pytest.raises(ConnectionError):
            for _ in range(3):          # first call may drain a buffer
                c.call("ping")


@pytest.mark.slow
class TestNodeAgent:
    def test_spawn_submit_map_stats(self):
        node = RemoteNode.spawn_local(num_workers=2,
                                      extra_sys_path=[TESTS_DIR])
        try:
            assert node.alive()
            assert node.submit(square, 7) == 49
            assert node.map(square, range(6)) == [0, 1, 4, 9, 16, 25]
            st = node.stats()
            assert st["num_workers"] == 2 and st["tasks_done"] == 7
            with pytest.raises(RpcError, match="synthetic remote failure"):
                node.submit(boom, 1)
        finally:
            node.close()

    def test_node_failure_detected(self):
        node = RemoteNode.spawn_local(num_workers=1,
                                      extra_sys_path=[TESTS_DIR])
        try:
            assert node.submit(square, 3) == 9
            node.kill()                 # simulated host loss
            assert not node.alive()
            with pytest.raises(ConnectionError):
                node.submit(square, 3)
        finally:
            node.close()

    def test_two_nodes_independent(self):
        a = RemoteNode.spawn_local(num_workers=1, extra_sys_path=[TESTS_DIR])
        b = RemoteNode.spawn_local(num_workers=1, extra_sys_path=[TESTS_DIR])
        try:
            assert a.submit(square, 2) == 4
            assert b.submit(square, 3) == 9
            a.kill()
            assert not a.alive() and b.alive()
            assert b.submit(square, 5) == 25    # survivor unaffected
        finally:
            a.close()
            b.close()


class TestBindGuard:
    def test_public_bind_warns(self):
        """The pickle protocol is RCE by design; non-loopback/non-private
        binds must warn loudly (loopback/private stay silent)."""
        import warnings
        from tosem_tpu_torch.cluster.rpc import _check_bind_host
        with warnings.catch_warnings():
            warnings.simplefilter("error")       # silence expected
            _check_bind_host("127.0.0.1")
            _check_bind_host("10.0.0.7")
            _check_bind_host("localhost")
        with pytest.warns(RuntimeWarning):
            _check_bind_host("0.0.0.0")
        with pytest.warns(RuntimeWarning):
            _check_bind_host("8.8.8.8")


# ------------------------------------------------------ across packages


PAYLOAD = {"deep": [1, 2.5, "x", None], "t": (1, 2), "b": b"\x00\xff"}


@pytest.mark.parametrize("server_pkg,client_pkg",
                         [("tosem_tpu", "tosem_tpu_torch"),
                          ("tosem_tpu_torch", "tosem_tpu")],
                         ids=["port-client", "port-server"])
def test_rpc_wire_between_packages(server_pkg, client_pkg):
    """One package's client calls the other's server: values, a remote
    error with its traceback, and an unknown method all cross."""
    import importlib
    srv_mod = importlib.import_module(f"{server_pkg}.cluster.rpc")
    cli_mod = importlib.import_module(f"{client_pkg}.cluster.rpc")
    srv = srv_mod.RpcServer(MathService())
    srv2 = srv_mod.RpcServer({"echo": lambda x: x})
    try:
        with cli_mod.RpcClient(srv.address) as c:
            assert c.add(20, 22) == 42
            with pytest.raises(cli_mod.RpcError,
                               match="service error") as ei:
                c.fail()
            assert "RuntimeError" in ei.value.remote_traceback
            with pytest.raises(cli_mod.RpcError,
                               match="no such RPC method"):
                c.call("_private")
        with cli_mod.RpcClient(srv2.address) as c:
            assert c.call("echo", PAYLOAD) == PAYLOAD
    finally:
        srv.shutdown()
        srv2.shutdown()


def test_frames_are_the_reference_bytes():
    """The length prefix and pickle body of a frame are byte for byte
    the JAX package's."""
    import socket

    import tosem_tpu.cluster.rpc as ref
    import tosem_tpu_torch.cluster.rpc as port
    got = []
    for mod in (ref, port):
        a, b = socket.socketpair()
        try:
            mod._send_frame(a, ("call", (PAYLOAD,), {"k": 1}))
            a.shutdown(socket.SHUT_WR)
            data = b""
            while True:
                chunk = b.recv(4096)
                if not chunk:
                    break
                data += chunk
            got.append(data)
        finally:
            a.close()
            b.close()
    assert got[0] == got[1]
    assert port.MAX_FRAME == ref.MAX_FRAME


# ----------------------------------------------------- import discipline


@pytest.mark.parametrize("module", [
    "tosem_tpu_torch.cluster.rpc", "tosem_tpu_torch.cluster.node",
    "tosem_tpu_torch.serve.replica_worker", "tosem_tpu_torch.serve.router"])
def test_agent_router_and_replica_modules_load_no_torch(module):
    """Node agents and routers never touch the card, and a replica loads
    torch only when it resolves its backend: importing these modules in
    a fresh interpreter leaves torch, numpy and JAX out."""
    code = (f"import sys, {module}; "
            "print(sorted(m for m in ('torch', 'numpy', 'jax', 'tosem_tpu')"
            " if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("module", [
    "tosem_tpu_torch.cluster.supervisor", "tosem_tpu_torch.cluster.gang",
    "tosem_tpu_torch.cluster.autoscaler", "tosem_tpu_torch.control",
    "tosem_tpu_torch.serve.autoscale", "tosem_tpu_torch.serve.cluster_serve",
    "tosem_tpu_torch.serve.bench_common",
    "tosem_tpu_torch.serve.bench_serve"])
def test_cluster_serving_modules_load_no_torch(module):
    """The head's side of cluster serving (the pool, gangs, the control
    plane, the controller and the benches' harness) imports no torch and
    nothing of the JAX package."""
    code = (f"import sys, {module}; "
            "print(sorted(m for m in ('torch', 'jax', 'tosem_tpu')"
            " if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.stdout.strip() == "[]"


def test_cluster_package_exports_resolve():
    import tosem_tpu_torch.cluster as cluster
    for name in cluster.__all__:
        assert getattr(cluster, name) is not None


def _gone(pid):
    """The process has exited (reaped, or a zombie no one reaped)."""
    try:
        with open(f"/proc/{pid}/status") as f:
            state = next(ln for ln in f if ln.startswith("State:"))
    except (FileNotFoundError, StopIteration):
        return True
    return "Z" in state.split()[1]


def test_task_pool_workers_die_with_a_killed_agent():
    """C-ref12: a SIGKILLed agent takes its task pool's spawned workers
    with it (the JAX package's stay behind, reparented and idle)."""
    import time
    node = RemoteNode.spawn_local(num_workers=1)
    try:
        worker = node.submit(os.getpid)
        assert worker != node._proc.pid and not _gone(worker)
        node.kill()
        deadline = time.monotonic() + 60.0
        while not _gone(worker) and time.monotonic() < deadline:
            time.sleep(0.1)
        assert _gone(worker)
    finally:
        node.close()
