"""Stub generator (the SWIG role): introspection + generated clients.

The reference generates its second-language bindings rather than
hand-writing them (SWIG: ``native_client/javascript/``, ``java/``,
``dotnet/``). These tests prove the generator the strongest way the
image allows: the generated **C++** stub is compiled with g++ and run
against a LIVE gateway (typed method calls round-trip real values);
Java/Node stubs (no runtimes in this image) are pinned structurally —
every registered method present, correct big-endian framing calls.
"""
import json
import os
import shutil
import subprocess
import sys

import pytest

from tosem_tpu_torch.cluster.stubgen import (MethodSpec, describe,
                                       describe_remote, generate_cpp,
                                       generate_java, generate_node,
                                       write_stubs)
from tosem_tpu_torch.cluster.xlang import XLangGateway, xlang_call


@pytest.fixture
def gateway():
    gw = XLangGateway()
    gw.register("add", lambda a, b: a + b)

    def greet(name):
        """Say hello."""
        return f"hello {name}"

    gw.register("greet", greet)
    yield gw
    gw.close()


class TestDescribe:
    def test_local_introspection(self, gateway):
        methods = {m.name: m for m in describe(gateway)}
        assert methods["add"].params == ("a", "b")
        assert methods["greet"].doc == "Say hello."
        assert "ping" in methods and "list_signatures" in methods

    def test_remote_introspection_over_the_wire(self, gateway):
        methods = {m.name: m for m in describe_remote(gateway.address)}
        assert methods["add"].params == ("a", "b")
        assert methods["greet"].doc == "Say hello."

    def test_ident_sanitizes_dotted_names(self):
        assert MethodSpec("node.kill_trial").ident == "node_kill_trial"

    def test_ident_collision_fails_generation(self):
        methods = [MethodSpec("node.kill_trial"),
                   MethodSpec("node_kill_trial")]
        with pytest.raises(ValueError, match="collision"):
            generate_cpp(methods)

    def test_csharp_collision_on_emitted_pascal_case(self):
        # distinct raw idents that COLLAPSE under C#'s PascalCase
        # transform (fooBar/foobar -> Foobar): the generated class would
        # contain a duplicate method and fail to compile — generation
        # must fail instead, while languages emitting the raw ident
        # still accept the pair
        from tosem_tpu_torch.cluster.stubgen import generate_csharp
        methods = [MethodSpec("fooBar"), MethodSpec("foobar")]
        with pytest.raises(ValueError, match="collision"):
            generate_csharp(methods)
        assert "fooBar" in generate_cpp(methods)   # raw idents distinct

    def test_node_stub_rejects_on_midframe_close(self, gateway):
        src = generate_node(describe(gateway))
        assert "sock.on('close'" in src and "mid-frame" in src


class TestGeneratedSources:
    def test_all_methods_present_everywhere(self, gateway):
        methods = describe(gateway)
        for src in (generate_cpp(methods), generate_java(methods),
                    generate_node(methods)):
            for m in methods:
                assert m.ident in src
            assert "GENERATED" in src

    def test_java_uses_big_endian_framing(self, gateway):
        src = generate_java(describe(gateway))
        assert "writeInt(payload.length)" in src
        assert "readFully" in src
        assert "public class TosemXlangClient" in src

    def test_node_uses_big_endian_framing(self, gateway):
        src = generate_node(describe(gateway))
        assert "writeUInt32BE" in src and "readUInt32BE" in src
        assert "module.exports" in src

    def test_csharp_swaps_endianness(self, gateway):
        from tosem_tpu_torch.cluster.stubgen import generate_csharp
        src = generate_csharp(describe(gateway))
        # BinaryWriter is little-endian; the wire is big-endian
        assert "HostToNetworkOrder" in src
        assert "NetworkToHostOrder" in src
        assert "public class TosemXlangClient" in src

    def test_swift_uses_big_endian_length(self, gateway):
        from tosem_tpu_torch.cluster.stubgen import generate_swift
        src = generate_swift(describe(gateway))
        assert ".bigEndian" in src and "UInt32(bigEndian:" in src
        assert "func call(" in src

    def test_write_stubs_emits_all_five_families(self, gateway,
                                                 tmp_path):
        from tosem_tpu_torch.cluster.stubgen import write_stubs
        paths = write_stubs(describe(gateway), str(tmp_path))
        assert sorted(paths) == ["cpp", "csharp", "java", "node",
                                 "swift"]
        for p in paths.values():
            assert os.path.getsize(p) > 500


@pytest.mark.slow
class TestCompiledCpp:
    @pytest.mark.skipif(shutil.which("g++") is None,
                        reason="no C++ toolchain on this image; the "
                               "structural stub checks above still "
                               "cover generation")
    def test_cpp_stub_compiles_and_calls_live_gateway(self, gateway,
                                                      tmp_path):
        paths = write_stubs(describe(gateway), str(tmp_path))
        host, port = gateway.address.split(":")
        main_cpp = tmp_path / "main.cpp"
        main_cpp.write_text(f'''
#include "{os.path.basename(paths["cpp"])}"
#include <cstdio>
int main() {{
  TosemXlangClient c("{host}", "{port}");
  std::string r1 = c.ping();
  if (!TosemXlangClient::ok(r1)) return 1;
  std::string r2 = c.add("2", "3");            // pre-serialized JSON args
  if (r2.find("\\"result\\": 5") == std::string::npos) return 2;
  std::string r3 = c.greet("\\"tpu\\"");
  if (r3.find("hello tpu") == std::string::npos) return 3;
  std::printf("%s\\n", r2.c_str());
  return 0;
}}
''')
        binary = tmp_path / "stub_demo"
        subprocess.run(["g++", "-std=c++17", "-O1", str(main_cpp),
                        "-o", str(binary)], check=True, cwd=tmp_path,
                       capture_output=True, timeout=180)
        proc = subprocess.run([str(binary)], capture_output=True,
                              text=True, timeout=60)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert '"result": 5' in proc.stdout

    def test_cpp_stub_drives_the_trial_plane_names(self, tmp_path):
        # bridged node-agent surface generates dotted->sanitized methods
        methods = [MethodSpec("node.submit_trial",
                              ("tid", "ref", "config", "iters")),
                   MethodSpec("node.kill_trial", ("tid",))]
        src = generate_cpp(methods)
        assert "node_submit_trial" in src and "node_kill_trial" in src
        assert '"node.submit_trial"' in src   # wire name keeps the dot
