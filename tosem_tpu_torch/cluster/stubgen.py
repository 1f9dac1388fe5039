"""Binding-stub generator over the cross-language wire — the SWIG role.

The reference does not hand-write its second-language surfaces: the
DeepSpeech bindings are *generated* (SWIG for Java/.NET/JavaScript,
``native_client/javascript/``, ``java/``, ``dotnet/``) and Ray's Java
API is stub-per-remote-function. This module is that practice for the
TPU framework: introspect an :class:`~tosem_tpu_torch.cluster.xlang.XLangGateway`
(live, over the wire, via the ``list_signatures`` builtin — or locally)
and emit ready-to-use client stubs:

- **C++** — single header, no dependencies beyond POSIX sockets; one
  typed method per registered function. Compiled AND run against a live
  gateway in CI (`tests/test_stubgen.py`), so the generator is proven,
  not decorative.
- **Java** — ``DataOutputStream``/``DataInputStream`` framing (Java's
  ``writeInt`` is already big-endian, matching the wire).
- **Node.js** — ``net.Socket`` with promise-returning wrappers.

Java/Node runtimes are not in this image, so those stubs are pinned
structurally by tests (every method present, correct framing calls)
rather than executed — same split as the reference's CI, which builds
bindings per-platform in dedicated workers (``taskcluster/``).

Usage::

    python -m tosem_tpu_torch.cluster.stubgen --address 127.0.0.1:7001 --out stubs/
    # or, in-process:
    write_stubs(describe(gw), "stubs/")

A copy of the JAX package's ``cluster/stubgen.py``.
"""
from __future__ import annotations

import inspect
import json
import os
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

__all__ = ["MethodSpec", "describe", "describe_remote", "generate_cpp",
           "generate_java", "generate_node", "generate_csharp",
           "generate_swift", "write_stubs"]


@dataclass(frozen=True)
class MethodSpec:
    name: str
    params: tuple = ()
    doc: str = ""

    @property
    def ident(self) -> str:
        """Language-safe identifier (``node.kill_trial`` → ``node_kill_trial``)."""
        return re.sub(r"\W", "_", self.name)


def _spec_from_fn(name: str, fn) -> MethodSpec:
    try:
        sig = inspect.signature(fn)
        params = tuple(p.name for p in sig.parameters.values()
                       if p.kind in (p.POSITIONAL_ONLY,
                                     p.POSITIONAL_OR_KEYWORD))
    except (TypeError, ValueError):
        params = ()
    doc = (inspect.getdoc(fn) or "").splitlines()
    return MethodSpec(name=name, params=params,
                      doc=doc[0] if doc else "")


def describe(gateway) -> List[MethodSpec]:
    """Introspect a local gateway object into method specs."""
    with gateway._lock:
        items = sorted(gateway._fns.items())
    return [_spec_from_fn(name, fn) for name, fn in items]


def describe_remote(address: str) -> List[MethodSpec]:
    """Introspect a LIVE gateway over the wire (the flow a non-Python
    team uses: point the generator at a running control plane)."""
    from tosem_tpu_torch.cluster.xlang import xlang_call
    try:
        sigs = xlang_call(address, "list_signatures")
        return [MethodSpec(name=s["name"], params=tuple(s["params"]),
                           doc=s.get("doc", "")) for s in sigs]
    except RuntimeError:
        # unknown-method error from an older gateway: names only.
        # (Transport failures — timeouts, resets — propagate: silently
        # emitting params-less stubs would hide the degradation.)
        names = xlang_call(address, "list_methods")
        return [MethodSpec(name=n) for n in names]


def _check_idents(methods: List[MethodSpec],
                  emit=lambda m: m.ident) -> None:
    """Distinct wire names must not collapse to the same identifier
    (``node.kill_trial`` vs ``node_kill_trial``) — the generated class
    would silently shadow one of them (Node) or fail to compile
    (C++/Java). Fail generation instead.

    ``emit`` maps a spec to the name the target language actually
    emits: languages that transform identifiers (C#'s PascalCase) can
    collapse names that are distinct as raw idents (``fooBar`` vs
    ``foobar`` → ``Foobar``), so the check must run on the emitted
    form, not the shared sanitized form."""
    seen: Dict[str, str] = {}
    for m in methods:
        emitted = emit(m)
        if emitted in seen and seen[emitted] != m.name:
            raise ValueError(
                f"method identifier collision: {seen[emitted]!r} and "
                f"{m.name!r} both generate {emitted!r}; rename one")
        seen[emitted] = m.name


def _cpp_method(m: MethodSpec) -> str:
    args = ", ".join(f"const std::string& {p}_json" for p in m.params)
    arg_list = ", ".join(f"{p}_json" for p in m.params)
    doc = f"  // {m.doc}\n" if m.doc else ""
    if m.params:
        body = (f"    return call(\"{m.name}\", "
                f"std::vector<std::string>{{{arg_list}}});")
    else:
        body = f"    return call(\"{m.name}\", {{}});"
    return (f"{doc}  std::string {m.ident}({args}) {{\n{body}\n  }}\n")


def generate_cpp(methods: List[MethodSpec],
                 class_name: str = "TosemXlangClient") -> str:
    """Single-header C++ client: framing + one method per function.

    Arguments are pre-serialized JSON strings (``"\\"text\\""``,
    ``"42"``) — the stub owns the wire, not a JSON library, keeping the
    generated surface dependency-free like the handwritten
    ``native/xlang_client.cpp`` it descends from.
    """
    _check_idents(methods)
    methods_src = "".join(_cpp_method(m) for m in methods)
    return f"""// GENERATED by tosem_tpu_torch.cluster.stubgen — do not edit.
// C++ client stub for the cross-language JSON wire (cluster/xlang.py):
// 4-byte big-endian length + UTF-8 JSON, request
// {{"method": name, "args": [...]}} -> response {{"ok": ..., ...}}.
#pragma once
#include <arpa/inet.h>
#include <netdb.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

class {class_name} {{
 public:
  {class_name}(const std::string& host, const std::string& port)
      : host_(host), port_(port) {{}}

  // generic escape hatch: args are pre-serialized JSON values
  std::string call(const std::string& method,
                   const std::vector<std::string>& json_args) {{
    std::string req = "{{\\"method\\": \\"" + method + "\\", \\"args\\": [";
    for (size_t i = 0; i < json_args.size(); ++i) {{
      if (i) req += ", ";
      req += json_args[i];
    }}
    req += "]}}";
    return roundtrip(req);
  }}

  static bool ok(const std::string& response) {{
    return response.find("\\"ok\\": true") != std::string::npos;
  }}

{methods_src}
 private:
  std::string host_, port_;

  int dial() {{
    addrinfo hints{{}};
    hints.ai_family = AF_INET;
    hints.ai_socktype = SOCK_STREAM;
    addrinfo* res = nullptr;
    if (getaddrinfo(host_.c_str(), port_.c_str(), &hints, &res) != 0 ||
        res == nullptr)
      throw std::runtime_error("stub: cannot resolve gateway");
    int fd = socket(res->ai_family, res->ai_socktype, res->ai_protocol);
    if (fd < 0 || connect(fd, res->ai_addr, res->ai_addrlen) != 0) {{
      if (fd >= 0) close(fd);
      freeaddrinfo(res);
      throw std::runtime_error("stub: connect failed");
    }}
    freeaddrinfo(res);
    return fd;
  }}

  static void send_all(int fd, const char* buf, size_t n) {{
    while (n > 0) {{
      ssize_t w = write(fd, buf, n);
      if (w <= 0) throw std::runtime_error("stub: short write");
      buf += w;
      n -= static_cast<size_t>(w);
    }}
  }}

  static void recv_all(int fd, char* buf, size_t n) {{
    while (n > 0) {{
      ssize_t r = read(fd, buf, n);
      if (r <= 0) throw std::runtime_error("stub: short read");
      buf += r;
      n -= static_cast<size_t>(r);
    }}
  }}

  std::string roundtrip(const std::string& payload) {{
    int fd = dial();
    try {{
      uint32_t len = htonl(static_cast<uint32_t>(payload.size()));
      send_all(fd, reinterpret_cast<const char*>(&len), 4);
      send_all(fd, payload.data(), payload.size());
      recv_all(fd, reinterpret_cast<char*>(&len), 4);
      len = ntohl(len);
      if (len > (64u << 20)) throw std::runtime_error("stub: huge frame");
      std::string out(len, '\\0');
      recv_all(fd, out.data(), len);
      close(fd);
      return out;
    }} catch (...) {{
      close(fd);
      throw;
    }}
  }}
}};
"""


def _java_method(m: MethodSpec) -> str:
    args = ", ".join(f"String {p}Json" for p in m.params)
    arg_list = ", ".join(f"{p}Json" for p in m.params)
    doc = f"  /** {m.doc} */\n" if m.doc else ""
    call = (f"call(\"{m.name}\", new String[]{{{arg_list}}})"
            if m.params else f"call(\"{m.name}\", new String[0])")
    return (f"{doc}  public String {m.ident}({args}) throws IOException "
            f"{{\n    return {call};\n  }}\n")


def generate_java(methods: List[MethodSpec],
                  class_name: str = "TosemXlangClient") -> str:
    _check_idents(methods)
    methods_src = "".join(_java_method(m) for m in methods)
    return f"""// GENERATED by tosem_tpu_torch.cluster.stubgen — do not edit.
// Java client stub for the cross-language JSON wire (cluster/xlang.py).
// DataOutputStream.writeInt is big-endian — exactly the 4-byte frame.
import java.io.DataInputStream;
import java.io.DataOutputStream;
import java.io.IOException;
import java.net.Socket;
import java.nio.charset.StandardCharsets;

public class {class_name} {{
  private final String host;
  private final int port;

  public {class_name}(String host, int port) {{
    this.host = host;
    this.port = port;
  }}

  public String call(String method, String[] jsonArgs) throws IOException {{
    StringBuilder req = new StringBuilder();
    req.append("{{\\"method\\": \\"").append(method).append("\\", \\"args\\": [");
    for (int i = 0; i < jsonArgs.length; i++) {{
      if (i > 0) req.append(", ");
      req.append(jsonArgs[i]);
    }}
    req.append("]}}");
    byte[] payload = req.toString().getBytes(StandardCharsets.UTF_8);
    try (Socket sock = new Socket(host, port)) {{
      DataOutputStream out = new DataOutputStream(sock.getOutputStream());
      out.writeInt(payload.length);
      out.write(payload);
      out.flush();
      DataInputStream in = new DataInputStream(sock.getInputStream());
      int len = in.readInt();
      if (len < 0 || len > (64 << 20)) throw new IOException("huge frame");
      byte[] resp = new byte[len];
      in.readFully(resp);
      return new String(resp, StandardCharsets.UTF_8);
    }}
  }}

  public static boolean ok(String response) {{
    return response.contains("\\"ok\\": true");
  }}

{methods_src}}}
"""


def _node_method(m: MethodSpec) -> str:
    args = ", ".join(f"{p}Json" for p in m.params)
    arg_list = ", ".join(f"{p}Json" for p in m.params)
    doc = f"  /** {m.doc} */\n" if m.doc else ""
    return (f"{doc}  {m.ident}({args}) {{\n"
            f"    return this.call(\"{m.name}\", [{arg_list}]);\n  }}\n")


def generate_node(methods: List[MethodSpec],
                  class_name: str = "TosemXlangClient") -> str:
    _check_idents(methods)
    methods_src = "".join(_node_method(m) for m in methods)
    return f"""// GENERATED by tosem_tpu_torch.cluster.stubgen — do not edit.
// Node.js client stub for the cross-language JSON wire (cluster/xlang.py).
'use strict';
const net = require('net');

class {class_name} {{
  constructor(host, port) {{
    this.host = host;
    this.port = port;
  }}

  // jsonArgs: array of pre-serialized JSON value strings
  call(method, jsonArgs) {{
    const req = '{{"method": "' + method + '", "args": [' +
        jsonArgs.join(', ') + ']}}';
    const payload = Buffer.from(req, 'utf8');
    const frame = Buffer.alloc(4 + payload.length);
    frame.writeUInt32BE(payload.length, 0);
    payload.copy(frame, 4);
    return new Promise((resolve, reject) => {{
      const sock = net.connect(this.port, this.host, () => sock.write(frame));
      let buf = Buffer.alloc(0);
      let settled = false;
      sock.on('data', (d) => {{
        buf = Buffer.concat([buf, d]);
        if (buf.length >= 4) {{
          const len = buf.readUInt32BE(0);
          if (buf.length >= 4 + len) {{
            settled = true;
            sock.end();
            resolve(JSON.parse(buf.slice(4, 4 + len).toString('utf8')));
          }}
        }}
      }});
      sock.on('error', (e) => {{ settled = true; reject(e); }});
      // a peer that closes without a full frame must reject, not hang
      sock.on('close', () => {{
        if (!settled) reject(new Error('connection closed mid-frame'));
      }});
    }});
  }}

{methods_src}}}

module.exports = {{ {class_name} }};
"""


def _csharp_name(m: MethodSpec) -> str:
    """The PascalCase method name the C# stub emits for a spec."""
    return m.ident.title().replace("_", "")


def _csharp_method(m: MethodSpec) -> str:
    args = ", ".join(f"string {p}Json" for p in m.params)
    arg_list = ", ".join(f"{p}Json" for p in m.params)
    doc = f"  /// <summary>{m.doc}</summary>\n" if m.doc else ""
    arr = f"new string[]{{{arg_list}}}" if m.params else "new string[0]"
    return (f"{doc}  public string {_csharp_name(m)}"
            f"({args}) {{\n    return Call(\"{m.name}\", {arr});\n  }}\n")


def generate_csharp(methods: List[MethodSpec],
                    class_name: str = "TosemXlangClient") -> str:
    """C# stub (the reference's .NET family, ``native_client/dotnet/``).

    .NET's ``BinaryReader``/``Writer`` are little-endian, so the 4-byte
    frame length goes through ``IPAddress.HostToNetworkOrder``.
    """
    # collision check on the PascalCase EMITTED names: ``fooBar`` and
    # ``foobar`` have distinct idents but both emit ``Foobar``, which
    # would fail to compile as a duplicate method
    _check_idents(methods, emit=_csharp_name)
    methods_src = "".join(_csharp_method(m) for m in methods)
    return f"""// GENERATED by tosem_tpu_torch.cluster.stubgen — do not edit.
// C# client stub for the cross-language JSON wire (cluster/xlang.py).
using System;
using System.IO;
using System.Net;
using System.Net.Sockets;
using System.Text;

public class {class_name} {{
  private readonly string host;
  private readonly int port;

  public {class_name}(string host, int port) {{
    this.host = host;
    this.port = port;
  }}

  public string Call(string method, string[] jsonArgs) {{
    var req = new StringBuilder();
    req.Append("{{\\"method\\": \\"").Append(method)
       .Append("\\", \\"args\\": [");
    for (int i = 0; i < jsonArgs.Length; i++) {{
      if (i > 0) req.Append(", ");
      req.Append(jsonArgs[i]);
    }}
    req.Append("]}}");
    byte[] payload = Encoding.UTF8.GetBytes(req.ToString());
    using (var client = new TcpClient(host, port)) {{
      var stream = client.GetStream();
      var writer = new BinaryWriter(stream);
      // BinaryWriter is little-endian; the wire is big-endian
      writer.Write(IPAddress.HostToNetworkOrder(payload.Length));
      writer.Write(payload);
      writer.Flush();
      var reader = new BinaryReader(stream);
      int len = IPAddress.NetworkToHostOrder(reader.ReadInt32());
      if (len < 0 || len > (64 << 20))
        throw new IOException("huge frame");
      byte[] resp = reader.ReadBytes(len);
      return Encoding.UTF8.GetString(resp);
    }}
  }}

  public static bool Ok(string response) {{
    return response.Contains("\\"ok\\": true");
  }}

{methods_src}}}
"""


def _swift_method(m: MethodSpec) -> str:
    args = ", ".join(f"_ {p}Json: String" for p in m.params)
    arg_list = ", ".join(f"{p}Json" for p in m.params)
    doc = f"  /// {m.doc}\n" if m.doc else ""
    return (f"{doc}  func {m.ident}({args}) throws -> String {{\n"
            f"    return try call(\"{m.name}\", [{arg_list}])\n  }}\n")


def generate_swift(methods: List[MethodSpec],
                   class_name: str = "TosemXlangClient") -> str:
    """Swift stub (the reference's ``native_client/swift/`` family) —
    Foundation ``Stream`` I/O, explicit big-endian length bytes."""
    _check_idents(methods)
    methods_src = "".join(_swift_method(m) for m in methods)
    return f"""// GENERATED by tosem_tpu_torch.cluster.stubgen — do not edit.
// Swift client stub for the cross-language JSON wire (cluster/xlang.py).
import Foundation

enum XlangError: Error {{ case transport(String) }}

final class {class_name} {{
  let host: String
  let port: UInt32

  init(host: String, port: UInt32) {{
    self.host = host
    self.port = port
  }}

  func call(_ method: String, _ jsonArgs: [String]) throws -> String {{
    let req = "{{\\"method\\": \\"\\(method)\\", \\"args\\": " +
        "[\\(jsonArgs.joined(separator: ", "))]}}"
    let payload = Array(req.utf8)
    var frame = [UInt8]()
    let n = UInt32(payload.count).bigEndian   // wire is big-endian
    withUnsafeBytes(of: n) {{ frame.append(contentsOf: $0) }}
    frame.append(contentsOf: payload)

    var input: InputStream?
    var output: OutputStream?
    Stream.getStreamsToHost(withName: host, port: Int(port),
                            inputStream: &input, outputStream: &output)
    guard let inp = input, let out = output else {{
      throw XlangError.transport("connect failed")
    }}
    inp.open(); out.open()
    defer {{ inp.close(); out.close() }}
    var sent = 0
    while sent < frame.count {{
      let w = frame[sent...].withUnsafeBufferPointer {{
        out.write($0.baseAddress!, maxLength: frame.count - sent)
      }}
      if w <= 0 {{ throw XlangError.transport("short write") }}
      sent += w
    }}
    func readExact(_ n: Int) throws -> [UInt8] {{
      var buf = [UInt8](repeating: 0, count: n)
      var got = 0
      while got < n {{
        let r = buf[got...].withUnsafeMutableBufferPointer {{
          inp.read($0.baseAddress!, maxLength: n - got)
        }}
        if r <= 0 {{ throw XlangError.transport("short read") }}
        got += r
      }}
      return buf
    }}
    let lenBytes = try readExact(4)
    let len = lenBytes.withUnsafeBytes {{
      UInt32(bigEndian: $0.load(as: UInt32.self))
    }}
    if len > (64 << 20) {{ throw XlangError.transport("huge frame") }}
    let body = try readExact(Int(len))
    return String(decoding: body, as: UTF8.self)
  }}

  static func ok(_ response: String) -> Bool {{
    return response.contains("\\"ok\\": true")
  }}

{methods_src}}}
"""


def write_stubs(methods: List[MethodSpec], out_dir: str,
                class_name: str = "TosemXlangClient") -> Dict[str, str]:
    """Emit all five stub families; returns {language: path}."""
    os.makedirs(out_dir, exist_ok=True)
    paths = {
        "cpp": os.path.join(out_dir, f"{class_name}.hpp"),
        "java": os.path.join(out_dir, f"{class_name}.java"),
        "node": os.path.join(out_dir, f"{class_name.lower()}.js"),
        "csharp": os.path.join(out_dir, f"{class_name}.cs"),
        "swift": os.path.join(out_dir, f"{class_name}.swift"),
    }
    with open(paths["cpp"], "w") as f:
        f.write(generate_cpp(methods, class_name))
    with open(paths["java"], "w") as f:
        f.write(generate_java(methods, class_name))
    with open(paths["node"], "w") as f:
        f.write(generate_node(methods, class_name))
    with open(paths["csharp"], "w") as f:
        f.write(generate_csharp(methods, class_name))
    with open(paths["swift"], "w") as f:
        f.write(generate_swift(methods, class_name))
    return paths


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="generate client stubs from a live xlang gateway")
    ap.add_argument("--address", required=True, help="host:port")
    ap.add_argument("--out", required=True)
    ap.add_argument("--class-name", default="TosemXlangClient")
    args = ap.parse_args(argv)
    methods = describe_remote(args.address)
    paths = write_stubs(methods, args.out, args.class_name)
    for lang, path in paths.items():
        print(f"{lang}: {path} ({len(methods)} methods)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
