"""Cross-language call surface (cluster/xlang.py): named functions
invoked ACROSS the language boundary over the JSON wire — the Ray
cross-language contract (java/api calling registered Python functions by
name, args narrowed to a neutral serialization).

A copy of ``tests/test_xlang.py`` against the port's
``cluster/xlang.py``: the gateway tests. Left out: the compiled C++
client's tests (``native/xlang_client.cpp``) and the HPO bridge, which
wait for the port's native C++ client (ROADMAP.md A14).
The last test holds the port's wire against the JAX package's client.
"""

import pytest

from tosem_tpu_torch.cluster.xlang import XLangGateway, xlang_call


class TestGateway:
    def test_python_reference_client(self):
        gw = XLangGateway()
        try:
            gw.register("add", lambda a, b: a + b)
            assert xlang_call(gw.address, "ping") == "pong"
            assert xlang_call(gw.address, "add", 2, 3) == 5
            assert "add" in xlang_call(gw.address, "list_methods")
        finally:
            gw.close()

    def test_remote_errors_surface_not_crash(self):
        gw = XLangGateway()
        try:
            gw.register("boom", lambda: 1 / 0)
            with pytest.raises(RuntimeError, match="ZeroDivisionError"):
                xlang_call(gw.address, "boom")
            with pytest.raises(RuntimeError, match="unknown method"):
                xlang_call(gw.address, "nope")
            # the connection/server survives the errors
            assert xlang_call(gw.address, "ping") == "pong"
        finally:
            gw.close()

    def test_non_json_result_is_a_remote_error(self):
        gw = XLangGateway()
        try:
            gw.register("bad", lambda: object())
            with pytest.raises(RuntimeError, match="TypeError"):
                xlang_call(gw.address, "bad")
        finally:
            gw.close()


def test_wire_is_the_reference_s_both_ways():
    """The JAX package's client calls the port's gateway, and the port's
    client calls the JAX package's: one JSON wire."""
    from tosem_tpu.cluster.xlang import XLangGateway as RefGateway
    from tosem_tpu.cluster.xlang import xlang_call as ref_call
    port_gw, ref_gw = XLangGateway(), RefGateway()
    try:
        port_gw.register("add", lambda a, b: a + b)
        ref_gw.register("add", lambda a, b: a + b)
        assert ref_call(port_gw.address, "add", 2, 3) == 5
        assert xlang_call(ref_gw.address, "add", 2, 3) == 5
        assert (sorted(xlang_call(port_gw.address, "list_methods"))
                == sorted(ref_call(ref_gw.address, "list_methods")))
    finally:
        port_gw.close()
        ref_gw.close()
