"""An external module for the -e hook, used by tests/test_torch_bridge.py:
one custom mutation that draws from the oracle's random stream, and a
post hook. Either package's ExternalModule loads it."""


def capabilities():
    return {"mutations", "post"}


def _stamp(ctx, ll, meta):
    n = ctx.r.rand(1000)
    head = ll[0] if ll and isinstance(ll[0], bytes) else b""
    return _stamp, [b"EXT%d!" % n + head] + list(ll[1:]), meta + [("ext", n)], 1


def mutations():
    return [(10, 5, _stamp, "ext")]


def post(data: bytes) -> bytes:
    return data + b"|post"
