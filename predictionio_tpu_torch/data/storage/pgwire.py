"""Minimal pure-Python PostgreSQL wire-protocol client (protocol v3).

The port of `predictionio_tpu/data/storage/pgwire.py`, the layer the
reference's JDBC driver and scalikejdbc play under its default storage
backend (`storage/jdbc/.../JDBC{LEvents,Models,...}.scala`). No psycopg
or pg8000 is assumed; this speaks the frontend/backend protocol over a
socket:

  - startup and authentication: trust, cleartext password (loopback or
    a verified TLS channel only), md5 and SCRAM-SHA-256
    (RFC 5802/7677, no channel binding), with libpq's `sslmode` subset
  - the extended query protocol (Parse/Bind/Describe/Execute/Sync) with
    text-format parameters, so values never interpolate into SQL
  - result decoding by type OID (integers, booleans, bytea hex, floats,
    text)

An ErrorResponse becomes a `PgError` carrying its SQLSTATE; `transient`
says which SQLSTATEs a retry can cure (class 08 connection exceptions,
53 insufficient resources, 57P01-57P03 shutdowns, 40001 and 40P01). A
lost connection raises `PgConnectionLost`, an OSError, so that the
storage layer's retry and breaker see it as transient. The receive
buffer is consumed by offset, so a large result costs one copy per
socket read, not one per row.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import socket
import struct
from base64 import b64decode, b64encode
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple


class PgError(Exception):
    """Server-reported error; `code` is the SQLSTATE (e.g. 23505 =
    unique_violation)."""

    def __init__(self, fields: Dict[str, str]):
        self.fields = fields
        self.code = fields.get("C", "")
        super().__init__(fields.get("M", "postgres error"))


class PgConnectionLost(ConnectionError):
    """The server closed the connection (or it broke mid-message): an
    OSError, so transient to the storage layer."""


_QUICKACK = getattr(socket, "TCP_QUICKACK", None)

UNIQUE_VIOLATION = "23505"
# SQLSTATEs a retry on a fresh connection can cure
_TRANSIENT_CLASSES = ("08", "53")
_TRANSIENT_CODES = {"57P01", "57P02", "57P03", "40001", "40P01"}


def transient(code: str) -> bool:
    """True when the SQLSTATE names a condition a retry can cure."""
    return code[:2] in _TRANSIENT_CLASSES or code in _TRANSIENT_CODES


# -- message encoding (pure functions; unit-tested directly) ---------------

def _msg(tag: bytes, payload: bytes) -> bytes:
    return tag + struct.pack("!I", len(payload) + 4) + payload


def encode_startup(user: str, database: str) -> bytes:
    body = struct.pack("!I", 196608)   # protocol 3.0
    for k, v in (("user", user), ("database", database)):
        body += k.encode() + b"\0" + v.encode() + b"\0"
    body += b"\0"
    return struct.pack("!I", len(body) + 4) + body


def encode_password(password: str) -> bytes:
    return _msg(b"p", password.encode() + b"\0")


def encode_md5_password(user: str, password: str, salt: bytes) -> bytes:
    inner = hashlib.md5(password.encode() + user.encode()).hexdigest()
    outer = hashlib.md5(inner.encode() + salt).hexdigest()
    return encode_password("md5" + outer)


def encode_parse(sql: str) -> bytes:
    return _msg(b"P", b"\0" + sql.encode() + b"\0" + struct.pack("!H", 0))


_U32 = struct.Struct("!I")
_NULL = struct.pack("!i", -1)


def encode_bind(params: Sequence[Optional[bytes]]) -> bytes:
    # unnamed portal and statement, one format code (text) for all
    parts = [b"\0\0", struct.pack("!HHH", 1, 0, len(params))]
    pack = _U32.pack
    for p in params:
        if p is None:
            parts.append(_NULL)
        else:
            parts.append(pack(len(p)))
            parts.append(p)
    parts.append(b"\0\0")                   # result formats: default text
    return _msg(b"B", b"".join(parts))


def encode_describe_portal() -> bytes:
    return _msg(b"D", b"P\0")


def encode_execute() -> bytes:
    return _msg(b"E", b"\0" + struct.pack("!I", 0))


def encode_sync() -> bytes:
    return _msg(b"S", b"")


# -- SCRAM-SHA-256 (RFC 5802), client side ----------------------------------

class ScramClient:
    """SCRAM-SHA-256 without channel binding. Exposed for direct
    unit-testing against the RFC 7677 example exchange."""

    def __init__(self, user: str, password: str,
                 nonce: Optional[str] = None):
        self.user = user
        self.password = password
        self.nonce = nonce or b64encode(os.urandom(18)).decode()
        self.gs2 = "n,,"
        self.client_first_bare = f"n={user},r={self.nonce}"

    def client_first(self) -> str:
        return self.gs2 + self.client_first_bare

    def client_final(self, server_first: str) -> str:
        attrs = dict(kv.split("=", 1) for kv in server_first.split(","))
        combined_nonce = attrs["r"]
        if not combined_nonce.startswith(self.nonce):
            raise PgError({"M": "SCRAM server nonce mismatch", "C": ""})
        salt = b64decode(attrs["s"])
        iters = int(attrs["i"])
        salted = hashlib.pbkdf2_hmac("sha256", self.password.encode(),
                                     salt, iters)
        client_key = hmac.new(salted, b"Client Key", hashlib.sha256).digest()
        stored_key = hashlib.sha256(client_key).digest()
        channel = "c=" + b64encode(self.gs2.encode()).decode()
        final_no_proof = f"{channel},r={combined_nonce}"
        auth_message = ",".join(
            (self.client_first_bare, server_first, final_no_proof)).encode()
        signature = hmac.new(stored_key, auth_message,
                             hashlib.sha256).digest()
        proof = bytes(a ^ b for a, b in zip(client_key, signature))
        self._server_key = hmac.new(salted, b"Server Key",
                                    hashlib.sha256).digest()
        self._auth_message = auth_message
        return final_no_proof + ",p=" + b64encode(proof).decode()

    def verify_server_final(self, server_final: str) -> bool:
        attrs = dict(kv.split("=", 1) for kv in server_final.split(","))
        expect = hmac.new(self._server_key, self._auth_message,
                          hashlib.sha256).digest()
        return hmac.compare_digest(b64decode(attrs["v"]), expect)


# -- result decoding --------------------------------------------------------

_INT_OIDS = {20, 21, 23, 26, 28}
_BOOL_OID = 16
_BYTEA_OID = 17
_FLOAT_OIDS = {700, 701, 1700}


def _decoder(oid: int):
    """The text-format decoder of one result column."""
    if oid in _INT_OIDS:
        return int
    if oid == _BOOL_OID:
        return lambda raw: raw == b"t"
    if oid in _FLOAT_OIDS:
        return float
    if oid == _BYTEA_OID:
        return lambda raw: decode_value(raw, oid)
    return lambda raw: raw.decode("utf-8")


def decode_value(raw: Optional[bytes], oid: int):
    if raw is None:
        return None
    if oid in _INT_OIDS:
        return int(raw)
    if oid == _BOOL_OID:
        return raw == b"t"
    if oid == _BYTEA_OID:
        text = raw.decode()
        if text.startswith("\\x"):
            return bytes.fromhex(text[2:])
        return raw   # legacy escape format not expected from PG >= 9
    if oid in _FLOAT_OIDS:
        return float(raw)
    return raw.decode("utf-8")


def encode_param(v) -> Optional[bytes]:
    if v is None:
        return None
    if type(v) is str:
        return v.encode("utf-8")
    if isinstance(v, bool):
        return b"true" if v else b"false"
    if isinstance(v, (bytes, bytearray, memoryview)):
        return b"\\x" + bytes(v).hex().encode()
    return str(v).encode("utf-8")


@dataclass
class QueryResult:
    rows: List[tuple]
    rowcount: int


class PgConnection:
    """One socket speaking the extended query protocol, autocommit."""

    # SSLRequest magic (protocol 1234.5679, Postgres docs 55.2.10)
    _SSL_REQUEST = struct.pack("!II", 8, 80877103)

    def __init__(self, host: str = "localhost", port: int = 5432, *,
                 user: str = "postgres", password: str = "",
                 database: str = "postgres", timeout: float = 10.0,
                 sslmode: str = "prefer"):
        """`sslmode` follows the libpq subset: 'disable' (never TLS),
        'prefer' (TLS if the server supports it, else plaintext — the
        libpq default), 'require' (TLS or fail, no cert verification),
        'verify-full' (TLS with CA + hostname verification)."""
        if sslmode not in ("disable", "prefer", "require", "verify-full"):
            raise ValueError(f"unknown sslmode {sslmode!r}")
        sock = socket.create_connection((host, port), timeout=timeout)
        tls_verified = False
        if sslmode != "disable":
            sock.sendall(self._SSL_REQUEST)
            resp = sock.recv(1)
            if resp not in (b"S", b"N"):
                # EOF or an ErrorResponse from a pre-SSL server:
                # anything but S/N is a hard error (libpq semantics) —
                # proceeding would desynchronize the protocol
                sock.close()
                raise PgError({"M": "SSL negotiation failed: unexpected "
                                    f"server response {resp!r}", "C": ""})
            if resp == b"S":
                import ssl as _ssl
                if sslmode == "verify-full":
                    ctx = _ssl.create_default_context()
                    tls_verified = True
                else:
                    # encryption without authentication (libpq's
                    # require semantics): stops passive sniffing; only
                    # verify-full defends against an active MITM
                    ctx = _ssl.SSLContext(_ssl.PROTOCOL_TLS_CLIENT)
                    ctx.check_hostname = False
                    ctx.verify_mode = _ssl.CERT_NONE
                sock = ctx.wrap_socket(sock, server_hostname=host)
            elif sslmode in ("require", "verify-full"):
                sock.close()
                raise PgError({"M": f"server does not support SSL but "
                                    f"sslmode={sslmode}", "C": ""})
            # 'N' + prefer: continue in plaintext
        self.sock = sock
        self._buf = bytearray()
        self._off = 0
        self.user = user
        # a cleartext password goes over loopback (no wire to tap) or a
        # verified TLS channel (sslmode=verify-full) only; md5 and SCRAM
        # go everywhere
        try:
            peer = self.sock.getpeername()[0]
        except OSError:
            peer = ""
        self._cleartext_ok = tls_verified or peer in ("127.0.0.1", "::1")
        self.sock.sendall(encode_startup(user, database))
        self._authenticate(password)
        # drain until ReadyForQuery
        self._wait_ready()

    # -- low-level framing --------------------------------------------------
    def _fill(self, need: int) -> None:
        """Read until `need` unconsumed bytes are buffered."""
        while len(self._buf) - self._off < need:
            if self._off:
                del self._buf[:self._off]
                self._off = 0
            if _QUICKACK is not None:
                # ack at once: a server that writes a reply's messages
                # one by one without TCP_NODELAY otherwise holds the
                # next behind this host's delayed ACK (about 40 ms)
                self.sock.setsockopt(socket.IPPROTO_TCP, _QUICKACK, 1)
            chunk = self.sock.recv(262144)
            if not chunk:
                raise PgConnectionLost("connection closed by server")
            self._buf += chunk

    def _recv_message(self) -> Tuple[bytes, bytes]:
        self._fill(5)
        off = self._off
        tag = bytes(self._buf[off:off + 1])
        (length,) = struct.unpack_from("!I", self._buf, off + 1)
        self._fill(1 + length)
        off = self._off
        payload = bytes(self._buf[off + 5:off + 1 + length])
        self._off = off + 1 + length
        return tag, payload

    @staticmethod
    def _error_fields(payload: bytes) -> Dict[str, str]:
        fields = {}
        for part in payload.split(b"\0"):
            if part:
                fields[chr(part[0])] = part[1:].decode("utf-8", "replace")
        return fields

    # -- auth ----------------------------------------------------------------
    def _authenticate(self, password: str) -> None:
        scram: Optional[ScramClient] = None
        while True:
            tag, payload = self._recv_message()
            if tag == b"E":
                raise PgError(self._error_fields(payload))
            if tag != b"R":
                continue   # parameter status / backend key before auth done
            (code,) = struct.unpack("!I", payload[:4])
            if code == 0:
                return
            if code == 3:
                if not self._cleartext_ok:
                    raise PgError({
                        "M": "server requested cleartext password "
                             "authentication over a connection that is "
                             "neither loopback nor verified TLS; "
                             "refusing", "C": ""})
                self.sock.sendall(encode_password(password))
            elif code == 5:
                self.sock.sendall(encode_md5_password(
                    self.user, password, payload[4:8]))
            elif code == 10:
                mechs = payload[4:].split(b"\0")
                if b"SCRAM-SHA-256" not in mechs:
                    raise PgError({"M": f"unsupported SASL mechanisms "
                                        f"{mechs}", "C": ""})
                scram = ScramClient(self.user, password)
                first = scram.client_first().encode()
                body = (b"SCRAM-SHA-256\0"
                        + struct.pack("!I", len(first)) + first)
                self.sock.sendall(_msg(b"p", body))
            elif code == 11:
                assert scram is not None
                final = scram.client_final(payload[4:].decode())
                self.sock.sendall(_msg(b"p", final.encode()))
            elif code == 12:
                assert scram is not None
                if not scram.verify_server_final(payload[4:].decode()):
                    raise PgError({"M": "SCRAM server signature invalid",
                                   "C": ""})
            else:
                raise PgError({"M": f"unsupported auth method {code}",
                               "C": ""})

    def _wait_ready(self) -> None:
        err = None
        while True:
            tag, payload = self._recv_message()
            if tag == b"E":
                err = PgError(self._error_fields(payload))
            elif tag == b"Z":
                if err:
                    raise err
                return

    # -- queries -------------------------------------------------------------
    def execute(self, sql: str, params: Sequence = ()) -> QueryResult:
        """Run one statement via the extended protocol; `$1..$n`
        placeholders; returns typed rows + affected rowcount."""
        self.sock.sendall(
            encode_parse(sql)
            + encode_bind([encode_param(p) for p in params])
            + encode_describe_portal()
            + encode_execute()
            + encode_sync())
        decoders: List = []
        rows: List[tuple] = []
        rowcount = 0
        err: Optional[PgError] = None
        i16 = struct.Struct("!h").unpack_from
        i32 = struct.Struct("!i").unpack_from
        while True:
            tag, payload = self._recv_message()
            if tag == b"D":                       # DataRow
                off = 2
                vals = []
                for dec in decoders:
                    (ln,) = i32(payload, off)
                    off += 4
                    if ln < 0:
                        vals.append(None)
                    else:
                        vals.append(dec(payload[off:off + ln]))
                        off += ln
                rows.append(tuple(vals))
            elif tag == b"T":                     # RowDescription
                (nf,) = i16(payload, 0)
                off = 2
                decoders = []
                for _ in range(nf):
                    off = payload.index(b"\0", off) + 1
                    (oid,) = struct.unpack_from("!I", payload, off + 6)
                    off += 18
                    decoders.append(_decoder(oid))
            elif tag == b"C":                     # CommandComplete
                words = payload.rstrip(b"\0").split()
                if words and words[-1].isdigit():
                    rowcount = int(words[-1])
            elif tag == b"E":
                err = PgError(self._error_fields(payload))
            elif tag == b"Z":                     # ReadyForQuery
                if err:
                    raise err
                return QueryResult(rows, rowcount)
            # ignore: ParseComplete(1) BindComplete(2) NoData(n)
            # ParameterStatus(S) NoticeResponse(N) EmptyQueryResponse(I)

    def close(self) -> None:
        try:
            self.sock.sendall(_msg(b"X", b""))
        except OSError:
            pass
        self.sock.close()
