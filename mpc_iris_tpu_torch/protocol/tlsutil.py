"""Optional TLS for the coordinator↔participant wire (copy of
``mpc_iris_tpu/protocol/tlsutil.py``).

The reference protocol is raw TCP with no transport security or peer
authentication (src/main.rs:405-445 — "no TLS, no auth" per SURVEY §5);
fine for its localhost experiments, not for parties on real networks. This
module adds standard TLS on top of the byte-identical wire: the stream
inside the tunnel is unchanged, so TLS and plaintext deployments are
record-for-record compatible.

Model: parties are identified by certificate, not DNS name — deployments
address each other by IP/host:port, so hostname checking is off and trust
comes from the `ca` bundle (every peer certificate, or a real CA, works as
the bundle). Passing `ca` to the server side enables MUTUAL TLS: the
participant then also authenticates the coordinator, which a share-holding
party should always do in production.

`generate_self_signed` mints a per-party key + certificate for tests and
small deployments (`tls-cert` CLI); requires the optional `cryptography`
package, while the contexts themselves are stdlib `ssl`.
"""

from __future__ import annotations

import datetime
import ssl


def server_context(certfile: str, keyfile: str,
                   ca: str | None = None) -> ssl.SSLContext:
    """TLS context for a participant server. `ca` (a PEM bundle of trusted
    peer certificates) turns on mutual TLS — clients must present a
    certificate from the bundle."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_3
    ctx.load_cert_chain(certfile, keyfile)
    if ca is not None:
        ctx.load_verify_locations(cafile=ca)
        ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx


def client_context(ca: str, certfile: str | None = None,
                   keyfile: str | None = None) -> ssl.SSLContext:
    """TLS context for the coordinator side. Trusts exactly the `ca` PEM
    bundle; hostname checking is disabled (peers are authenticated by
    certificate, addressed by IP). Pass cert AND key when the participant
    requires mutual TLS."""
    if (certfile is None) != (keyfile is None):
        raise ValueError("mutual TLS needs both a certificate and its key")
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_3
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_REQUIRED
    ctx.load_verify_locations(cafile=ca)
    if certfile is not None:
        ctx.load_cert_chain(certfile, keyfile)
    return ctx


def generate_self_signed(prefix: str, common_name: str,
                         days: int = 365) -> tuple[str, str]:
    """Write `<prefix>.key` + `<prefix>.crt` (PEM, EC P-256 self-signed) and
    return their paths. The certificate doubles as its own trust anchor:
    hand the .crt to peers as (part of) their `ca` bundle."""
    try:
        from cryptography import x509
        from cryptography.hazmat.primitives import hashes, serialization
        from cryptography.hazmat.primitives.asymmetric import ec
        from cryptography.x509.oid import NameOID
    except ImportError as e:
        raise RuntimeError(
            "generating certificates needs the `cryptography` package; "
            "provision TLS keys/certs externally instead"
        ) from e

    key = ec.generate_private_key(ec.SECP256R1())
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, common_name)])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=days))
        .add_extension(x509.BasicConstraints(ca=True, path_length=None),
                       critical=True)
        .sign(key, hashes.SHA256())
    )
    key_path, crt_path = prefix + ".key", prefix + ".crt"
    import os

    fd = os.open(key_path, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o600)
    with os.fdopen(fd, "wb") as f:
        f.write(key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption(),
        ))
    with open(crt_path, "wb") as f:
        f.write(cert.public_bytes(serialization.Encoding.PEM))
    return key_path, crt_path
