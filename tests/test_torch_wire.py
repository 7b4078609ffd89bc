"""The port's selector wire (`predictionio_tpu_torch/utils/wire.py`) on
the CPU, held against the JAX package's `utils/wire.py`:

- `frame_request` on the same byte strings the JAX framing tests build
  (partial heads, pipelining, every 400/413/431/501 reject, the
  keep-alive defaults) gives the same request fields, consumed counts
  and statuses in both packages; `build_response` gives the same bytes;
- the binary query codec: the same frames for the same queries, the
  same decode (or refusal) of boundary shapes, mutated frames and
  noise, and a hypothesis round trip;
- the fast route's query regex accepts exactly what the JAX one does;
- a live `SelectorWire`: keep-alive reuse, pipelined responses in
  order, a burst leaving in fewer gathered `sendmsg` flushes than
  responses, `flush_hint` releasing a deferred response;
- `ShardedWire` at 2 reactors, with and without SO_REUSEPORT.

Every socket carries a timeout; no test asserts a rate."""

import random
import select
import socket
import threading
import time

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from predictionio_tpu.serving import server as jsrv
from predictionio_tpu.utils import wire as jw
from predictionio_tpu_torch.serving import server as psrv
from predictionio_tpu_torch.utils import wire as pw

pytestmark = pytest.mark.torch


def _req(path="/echo", body=b"", version="1.1", method="POST",
         headers=()):
    head = [f"{method} {path} HTTP/{version}".encode("ascii"), b"Host: t"]
    if body or method == "POST":
        head.append(b"Content-Length: %d" % len(body))
    head.extend(headers)
    return b"\r\n".join(head) + b"\r\n\r\n" + body


# the JAX framing cases' byte strings, and a few more
FRAMES = [
    b"POST /q HTTP/1.1\r\nHost: t\r\n",
    b"POST /q HTTP/1.1\r\nHost: t\r\nContent-Length: 2\r\n\r\n",
    b"POST /q HTTP/1.1\r\nHost: t\r\nContent-Length: 2\r\n\r\nhi",
    _req(body=b"one") + _req(body=b"three"),
    _req(path="/queries.json?accessKey=K&x=1"),
    *[b"POST / HTTP/1.1\r\nContent-Length: " + cl + b"\r\n\r\n"
      for cl in (b"abc", b"-1", b"1e3", b"0x10", b"")],
    b"POST / HTTP/1.1\r\nContent-Length: %d\r\n\r\n"
    % (pw.MAX_BODY_BYTES + 1),
    b"POST / HTTP/1.1\r\nContent-Length: %d\r\n\r\n" % pw.MAX_BODY_BYTES,
    b"POST / HTTP/1.1\r\nX: " + b"a" * (pw.MAX_HEADER_BYTES + 8),
    *[line + b"\r\n" for line in (b"POST /\r\n", b"POST / HTTP/1.1 x\r\n",
                                  b"POST / SPDY/3\r\n", b"POST / HTTP/2\r\n")],
    b"POST / HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n",
    _req(), _req(headers=(b"Connection: close",)), _req(version="1.0"),
    _req(version="1.0", headers=(b"Connection: keep-alive",)),
    _req(headers=(b"X-Request-ID: rid-7", b"AUTHORIZATION: Bearer t")),
    _req(method="GET", path="/metrics"),
    b"GET /status.json HTTP/1.1\r\nconnection: CLOSE\r\n\r\n",
]


def _frame(mod, data: bytes):
    """(fields, consumed) or ("error", status) of one frame."""
    try:
        raw, consumed = mod.frame_request(bytearray(data), "c")
    except mod.WireError as e:
        return "error", e.status, e.message
    if raw is None:
        return None, consumed
    return ((raw.method, raw.target, raw.path, raw.query_string, raw.head,
             raw.body, raw.keep_alive, raw.client,
             raw.header("x-request-id"), raw.header("Authorization"),
             raw.header_items()), consumed)


@pytest.mark.parametrize("data", FRAMES)
def test_framing_equals_the_jax_framing(data):
    assert _frame(pw, data) == _frame(jw, data)


def test_pipelined_frames_consume_alike():
    buf_p = bytearray(_req(body=b"one") + _req(body=b"three")
                      + _req(body=b"two")[:-1])
    buf_j = bytearray(buf_p)
    for _ in range(3):
        (rp, cp), (rj, cj) = pw.frame_request(buf_p), jw.frame_request(buf_j)
        assert cp == cj
        if rp is None:
            assert rj is None
            break
        assert (rp.body, rp.path) == (rj.body, rj.path)
        del buf_p[:cp], buf_j[:cj]
    assert bytes(buf_p) == bytes(buf_j)


@pytest.mark.parametrize("args", [
    (200, "application/json", b'{"a": 1}', "r1", {"Retry-After": "2"},
     False, False),
    (503, "application/json", b'{"message": "x"}', "", None, True, False),
    (404, "text/plain", b"nope", "rid", None, True, True),
    (299, "application/x-pio-bin", b"\x00\x01", "", {"X-A": "b"}, True,
     False),
])
def test_build_response_equals_the_jax_bytes(args):
    status, ct, body, rid, extra, keep, head_only = args
    kw = dict(rid=rid, extra=extra, keep_alive=keep, head_only=head_only)
    assert pw.build_response(status, ct, body, **kw) == \
        jw.build_response(status, ct, body, **kw)


BIN_CASES = [("", 0), ("u", 1), ("a" * 31, 127), ("a" * 32, 128),
             ("a" * 255, 0xffff), ("a" * 256, 0x10000),
             ("ünïcødé漢", -1), ("u", -32), ("u", -33),
             ("u", 999_999_999), ("u", -999_999_999)]


@pytest.mark.parametrize("user,num", BIN_CASES)
def test_binary_frames_equal_the_jax_frames(user, num):
    frame = pw.encode_bin_query(user, num)
    assert frame == jw.encode_bin_query(user, num)
    assert pw.decode_bin_query(frame) == jw.decode_bin_query(frame) == (
        user, num)


def test_binary_decode_refuses_what_the_jax_decoder_refuses():
    good = pw.encode_bin_query("abc", 12)
    bad = bytearray(pw.encode_bin_query("ab", 1))
    bad[7] = 0xff
    cases = [good + b"\x00", good[:-1], b"", b'{"user": "u", "num": 1}',
             b"\x82\xa3num\x01\xa4user\xa1u", bytes(bad),
             b"\x82\xa4user\xa1u\xa3num\xd2"
             + (1_000_000_000).to_bytes(4, "big", signed=True)]
    rng = random.Random(0xB1AB1A)
    for _ in range(2000):
        frame = bytearray(good)
        op, pos = rng.randrange(3), rng.randrange(len(frame))
        if op == 0:
            frame[pos] = rng.randrange(256)
        elif op == 1:
            frame.insert(pos, rng.randrange(256))
        else:
            del frame[pos]
        cases.append(bytes(frame))
        cases.append(bytes(rng.randrange(256)
                           for _ in range(rng.randrange(0, 24))))
    for frame in cases:
        assert pw.decode_bin_query(frame) == jw.decode_bin_query(frame), \
            frame
    for frame in cases[:8]:
        assert pw.decode_bin_query(frame) is None
    with pytest.raises(ValueError):
        pw.encode_bin_query("u", 1_000_000_000)
    with pytest.raises(ValueError):
        pw.encode_bin_query("x" * 70000, 1)


@settings(max_examples=300, deadline=None)
@given(user=st.text(max_size=300), num=st.integers(-999_999_999,
                                                     999_999_999))
def test_binary_round_trip(user, num):
    try:
        frame = pw.encode_bin_query(user, num)
    except ValueError:
        # ids past str16 are refused by both encoders alike
        with pytest.raises(ValueError):
            jw.encode_bin_query(user, num)
        return
    assert pw.decode_bin_query(frame) == (user, num)
    assert frame == jw.encode_bin_query(user, num)


def test_fast_query_regex_equals_the_jax_regex():
    rng = random.Random(0xA11CE)
    bodies = [b'{"user": "u1", "num": 4}', b'{"user":"u1","num":4}',
              b' \t\r\n{ "user" : "a b" , "num" : -3 }\n',
              b'{"num": 4, "user": "u1"}', b'{"user": "a\\"b", "num": 4}',
              b'{"user": "u", "num": 01}', b'{"user": "u1", "num": 4.0}',
              b'{"user": "u1", "num": 1234567890}', b"", b"[]"]
    for _ in range(3000):
        body = bytearray(b'{"user": "abc", "num": 12}')
        op, pos = rng.randrange(3), rng.randrange(len(body))
        if op == 0:
            body[pos] = rng.randrange(32, 127)
        elif op == 1:
            body.insert(pos, rng.randrange(32, 127))
        else:
            del body[pos]
        bodies.append(bytes(body))
    hits = 0
    for body in bodies:
        mp, mj = (psrv._FAST_QUERY_RE.match(body),
                  jsrv._FAST_QUERY_RE.match(body))
        assert (mp is None) == (mj is None), body
        if mp is not None:
            hits += 1
            assert mp.groups() == mj.groups()
    assert hits > 100


# -- the live reactor --------------------------------------------------------

def _echo(raw):
    if raw.path == "/slow":
        time.sleep(0.5)
    body = b"%s %s %s" % (raw.method.encode("ascii"),
                          raw.path.encode("ascii"), raw.body)
    return (pw.build_response(200, "text/plain", body,
                              keep_alive=raw.keep_alive),
            not raw.keep_alive)


def _run(srv):
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, t


def _stop(srv, t):
    srv.shutdown()
    srv.server_close()
    t.join(timeout=5)


def _connect(srv) -> socket.socket:
    s = socket.create_connection(srv.server_address, timeout=10)
    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return s


def _read_response(f):
    status = int(f.readline().split(b" ")[1])
    length, closing = 0, False
    while True:
        line = f.readline().rstrip(b"\r\n")
        if not line:
            break
        name, _, value = line.partition(b":")
        if name.lower() == b"content-length":
            length = int(value)
        if name.lower() == b"connection" and \
                value.strip().lower() == b"close":
            closing = True
    return status, f.read(length), closing


def _settled(srv, key, n, timeout=10.0):
    """The wire's snapshot once `key` reads `n`: a worker counts a
    response just after its bytes leave, so the client may read it
    first."""
    end = time.monotonic() + timeout
    snap = srv.stats_snapshot()
    while snap[key] != n and time.monotonic() < end:
        time.sleep(0.01)
        snap = srv.stats_snapshot()
    return snap


def test_keepalive_pipelining_and_close():
    srv, t = _run(pw.SelectorWire(("127.0.0.1", 0), _echo, workers=2))
    try:
        with _connect(srv) as s, s.makefile("rb") as f:
            for i in range(6):                      # one connection
                s.sendall(_req(body=b"n=%d" % i))
                status, body, closing = _read_response(f)
                assert (status, body, closing) == (
                    200, b"POST /echo n=%d" % i, False)
            s.sendall(b"".join(_req(body=b"p%d" % i) for i in range(8)))
            for i in range(8):                      # in request order
                assert _read_response(f)[1] == b"POST /echo p%d" % i
            s.sendall(_req(headers=(b"Connection: close",)))
            assert _read_response(f)[2] is True
            assert f.read(1) == b""
        with _connect(srv) as s, s.makefile("rb") as f:
            s.sendall(b"POST / HTTP/1.1\r\nContent-Length: zz\r\n\r\n")
            status, body, _ = _read_response(f)
            assert status == 400 and f.read(1) == b""
        snap = srv.stats_snapshot()
        assert snap["accepted"] == 2 and snap["errors"] == {400: 1}
    finally:
        _stop(srv, t)


def test_gathered_egress_coalesces_a_burst():
    srv, t = _run(pw.SelectorWire(("127.0.0.1", 0), _echo, workers=2))
    try:
        with _connect(srv) as s, s.makefile("rb") as f:
            s.sendall(b"".join(_req(body=b"b%d" % i) for i in range(16)))
            for i in range(16):
                assert _read_response(f)[:2] == (200, b"POST /echo b%d" % i)
        snap = _settled(srv, "responses", 16)
        assert snap["responses"] == 16 and 0 < snap["flushes"] < 16
    finally:
        _stop(srv, t)


def test_flush_hint_releases_a_deferred_response():
    srv, t = _run(pw.SelectorWire(("127.0.0.1", 0), _echo, workers=1))
    try:
        with _connect(srv) as s, s.makefile("rb") as f:
            s.sendall(_req(body=b"first") + _req(path="/slow",
                                                  body=b"second"))
            t0 = time.monotonic()
            readable = []
            while time.monotonic() - t0 < 0.45:
                srv.flush_hint()
                readable, _, _ = select.select([s], [], [], 0.02)
                if readable:
                    break
            assert readable, "the hint never flushed the first response"
            assert _read_response(f)[1] == b"POST /echo first"
            assert _read_response(f)[1] == b"POST /slow second"
    finally:
        _stop(srv, t)


@pytest.mark.parametrize("reuse_port", [True, False])
def test_sharded_wire_at_two_reactors(reuse_port, monkeypatch):
    if reuse_port and not hasattr(socket, "SO_REUSEPORT"):
        pytest.skip("SO_REUSEPORT unavailable on this platform")
    if not reuse_port:
        monkeypatch.delattr(socket, "SO_REUSEPORT", raising=False)
    srv, t = _run(pw.ShardedWire(("127.0.0.1", 0), _echo, reactors=2,
                                 workers=2))
    try:
        assert srv.reuse_port is reuse_port
        for i in range(8):
            with _connect(srv) as s, s.makefile("rb") as f:
                s.sendall(_req(body=b"c%d-a" % i) + _req(body=b"c%d-b" % i))
                assert _read_response(f)[1] == b"POST /echo c%d-a" % i
                assert _read_response(f)[1] == b"POST /echo c%d-b" % i
        snap = _settled(srv, "responses", 16)
        assert snap["requests"] == snap["responses"] == 16
        assert snap["accepted"] == 8
        assert [p["reactor"] for p in snap["reactors"]] == [0, 1]
        if not reuse_port:          # the strict round-robin deal
            assert [p["accepted"] for p in snap["reactors"]] == [4, 4]
    finally:
        _stop(srv, t)


def test_connection_pool_reuses_a_kept_alive_connection():
    srv, t = _run(pw.SelectorWire(("127.0.0.1", 0), _echo, workers=2))
    pool = pw.HTTPConnectionPool(max_idle_per_host=2)
    try:
        host, port = srv.server_address
        for i in range(3):
            status, headers, body = pool.request(
                host, port, "POST", "/echo", b"x%d" % i,
                {"Content-Type": "text/plain"}, timeout=10)
            assert (status, body) == (200, b"POST /echo x%d" % i)
        assert srv.stats_snapshot()["accepted"] == 1
    finally:
        pool.close()
        _stop(srv, t)
