"""Multi-host runtime: a torch.distributed.TCPStore, per-host BLOW5 record
ranges and deterministic ordered PAF emission.

The counterpart of sigfish_tpu/parallel/distributed.py, with its names
and its protocol. N independent host processes each map a *contiguous,
byte-balanced* range of the BLOW5 records on their own devices (reads
are data-parallel; the reference tracks are built by every host), and
host 0 emits the merged PAF/SAM. Because the ranges are contiguous and
in file order, the merged output (host 0's lines, then host 1's, ...)
is byte-identical to a single-process run.

The JAX module uses only the key-value store of jax.distributed's
coordination service; here that store is a TCPStore whose server runs
in host 0's process. There is no process group, no gloo and no NCCL:
the end-of-run gather needs no shared filesystem and no collective.

A TCPStore has no counterpart of jax.distributed.shutdown(), the
cluster-wide barrier before the service goes away, and host 0's process
owns the server. So shutdown_distributed is an explicit exit barrier:
each peer sets bye/<h> once it has read host 0's last confirmation, and
host 0 waits for every bye key before it lets the store go. A peer
whose connection to host 0 drops fails naming host 0; host 0 waiting on
a dead peer fails after the gather timeout naming that peer.

Record ranges come from one index pass (io/blow5_idx.py, cached as the
binary-compatible ``.idx`` sidecar, written atomically, so hosts that
race to create it are safe): each host seeks straight to its range
start instead of scanning the file.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta


@dataclass
class HostRange:
    """Contiguous record range [rec_start, rec_start+n_records) with the
    file offset of the first record (for Slow5File.seek_record)."""

    rec_start: int
    n_records: int
    file_offset: int


# generous join timeout: on an oversubscribed host a peer process can be
# starved of CPU for minutes (observed under concurrent test load), and
# a short one then fails a healthy cluster
_JOIN_TIMEOUT_S = 600

# the cluster this process joined (None before init_distributed), as
# jax.distributed keeps its client in a module global
_cluster: dict | None = None


def init_distributed(
    coordinator: str, num_processes: int, process_id: int
) -> None:
    """Join the cluster (idempotent); a no-op for one process.

    coordinator: "ADDR:PORT" of host 0. Host 0 opens the store's server
    on PORT; a peer connects as a client, retrying until the join
    timeout if it starts before host 0. Host 0 returns once every peer
    has joined.
    """
    global _cluster
    if num_processes <= 1 or _cluster is not None:
        return
    from torch.distributed import TCPStore

    addr, _, port = coordinator.rpartition(":")
    if not addr or not port.isdigit():
        raise ValueError(f"--coordinator {coordinator!r}: need ADDR:PORT")
    store = TCPStore(
        addr, int(port), world_size=num_processes, is_master=process_id == 0,
        timeout=timedelta(seconds=_JOIN_TIMEOUT_S), wait_for_workers=True,
    )
    _cluster = {"store": store, "process_id": process_id, "num_processes": num_processes}


def _kv_store():
    if _cluster is None:
        raise RuntimeError(
            "the cluster is not initialized; call init_distributed first"
        )
    return _cluster["store"]


def compute_host_ranges(sf, n_hosts: int) -> list[HostRange]:
    """Byte-balanced contiguous split of a Slow5File's records.

    One index pass (reusing/creating the .idx sidecar); split points are
    chosen so every host's byte total approximates total/n_hosts, like
    the reference's -B batching balances by bytes (sigfish.c:283-301).
    """
    idx = sf.index_load()
    entries = sorted(
        (idx.get(rid) for rid in idx.ids()), key=lambda e: e[0]
    )  # (offset, size) in file order
    n = len(entries)
    total = sum(sz for _, sz in entries)
    ranges: list[HostRange] = []
    start = 0
    cum = 0
    for h in range(n_hosts):
        target = total * (h + 1) / n_hosts
        end = start
        while end < n and (h == n_hosts - 1 or cum + entries[end][1] <= target
                           or end == start):
            cum += entries[end][1]
            end += 1
        ranges.append(
            HostRange(
                rec_start=start,
                n_records=end - start,
                file_offset=entries[start][0] if start < n else 0,
            )
        )
        start = end
    return ranges


_GATHER_PREFIX = "sigfish_tpu/gather"
# advances in the same order on every host: the stream, then the counters
_gather_round = [0]


def _gather_timeout_ms(default: int = 600_000) -> int:
    """SIGFISH_GATHER_TIMEOUT_MS overrides how long a host waits for a
    peer's contribution before declaring it dead (failure detection:
    without a bound, one crashed peer stalls the whole cluster)."""
    return int(os.environ.get("SIGFISH_GATHER_TIMEOUT_MS", default))


def _blocking_get(store, key: str, timeout_ms: int, what: str) -> bytes:
    """Wait for a key and read it, with a diagnosis instead of the
    store's raw error: names the missing peer (a wait that timed out) or
    host 0 (a connection that dropped), so a crashed or hung host is
    identifiable from the survivors' error output."""
    from torch.distributed import DistNetworkError

    try:
        store.wait([key], timedelta(milliseconds=timeout_ms))
        return store.get(key)
    except DistNetworkError as e:
        raise _lost_host0(e, f"waiting for {what} (key {key!r})") from e
    except RuntimeError as e:
        raise RuntimeError(
            f"distributed gather timed out after {timeout_ms} ms waiting "
            f"for {what} (key {key!r}): a peer process has likely "
            f"crashed or hung; its range was NOT merged"
        ) from e


def _lost_host0(e: Exception, doing: str) -> RuntimeError:
    return RuntimeError(
        f"distributed gather lost its connection to host 0's store while "
        f"{doing}: host 0 has likely crashed ({e})"
    )


def _set(store, key: str, value) -> None:
    from torch.distributed import DistNetworkError

    try:
        store.set(key, value)
    except DistNetworkError as e:
        raise _lost_host0(e, f"setting {key!r}") from e


def _delete(store, key: str) -> None:
    from torch.distributed import DistNetworkError

    try:
        store.delete_key(key)
    except DistNetworkError as e:
        raise _lost_host0(e, f"deleting {key!r}") from e


def gather_ordered(data: bytes, process_id: int, num_processes: int,
                   timeout_ms: int | None = None) -> bytes | None:
    """All hosts contribute bytes; host 0 returns them concatenated in
    host order, others return None.

    Uses the store (no shared FS, no collectives), in chunks of 2 MiB.
    """
    if timeout_ms is None:
        timeout_ms = _gather_timeout_ms()
    store = _kv_store()
    rnd = _gather_round[0]
    _gather_round[0] += 1
    chunk = 2 * 1024 * 1024
    nchunks = (len(data) + chunk - 1) // chunk if data else 0
    _set(store, f"{_GATHER_PREFIX}/{rnd}/{process_id}/nchunks", str(nchunks))
    for c in range(nchunks):
        _set(store, f"{_GATHER_PREFIX}/{rnd}/{process_id}/{c}",
             data[c * chunk : (c + 1) * chunk])
    if process_id != 0:
        # wait until host 0 confirms the merge so the entries stay alive
        # long enough
        _blocking_get(store, f"{_GATHER_PREFIX}/{rnd}/done",
                      timeout_ms, "host 0's merge confirmation")
        return None
    parts: list[bytes] = []
    for h in range(num_processes):
        key = f"{_GATHER_PREFIX}/{rnd}/{h}/nchunks"
        nc = int(_blocking_get(store, key, timeout_ms,
                               f"host {h}'s chunk count"))
        _delete(store, key)
        for c in range(nc):
            key = f"{_GATHER_PREFIX}/{rnd}/{h}/{c}"
            parts.append(_blocking_get(store, key, timeout_ms,
                                       f"host {h}'s chunk {c}"))
            # free each chunk as it is consumed: the store otherwise
            # retains every host's full payload until the run ends
            _delete(store, key)
    _set(store, f"{_GATHER_PREFIX}/{rnd}/done", "1")
    return b"".join(parts)


def gather_ordered_stream(
    body_fp,
    out_fp,
    process_id: int,
    num_processes: int,
    timeout_ms: int | None = None,
    chunk: int | None = None,
    window: int | None = None,
) -> None:
    """Stream every host's body file into ``out_fp`` on host 0, in host
    order, with bounded memory on every node.

    ``body_fp`` is each host's own output as a seekable *binary* file
    (disk-backed, so a host never holds its full output in RAM).
    Host 0 writes its own body straight to ``out_fp`` (no store round
    trip), then drains peers in host order, deleting each chunk as it
    lands. Peers publish chunks under a credit window: chunk c goes up
    only after host 0 acknowledged chunk c-window, so the store holds at
    most ~window chunks per peer at any moment instead of the whole
    payload. Output bytes are ASCII (PAF/SAM), so chunk-boundary
    decoding is safe.

    Env overrides (mainly for tests): SIGFISH_GATHER_CHUNK bytes,
    SIGFISH_GATHER_WINDOW chunks.
    """
    if chunk is None:
        chunk = int(os.environ.get("SIGFISH_GATHER_CHUNK", 2 * 1024 * 1024))
    if window is None:
        window = int(os.environ.get("SIGFISH_GATHER_WINDOW", 8))
    # chunk=0 divides by zero; window=0 deadlocks every peer on an ack
    # host 0 can never write (peer waits for chunk -window..-1 acks)
    chunk = max(1, chunk)
    window = max(1, window)
    if timeout_ms is None:
        timeout_ms = _gather_timeout_ms()
    store = _kv_store() if num_processes > 1 else None
    rnd = _gather_round[0]
    _gather_round[0] += 1
    pre = f"{_GATHER_PREFIX}/s{rnd}"

    body_fp.seek(0, 2)
    size = body_fp.tell()
    body_fp.seek(0)
    nchunks = (size + chunk - 1) // chunk if size else 0

    if process_id != 0:
        _set(store, f"{pre}/{process_id}/nchunks", str(nchunks))
        for c in range(nchunks):
            if c >= window:
                ack = f"{pre}/ack/{process_id}/{c - window}"
                _blocking_get(store, ack, timeout_ms,
                              "host 0's flow-control ack")
                _delete(store, ack)
            _set(store, f"{pre}/{process_id}/{c}", body_fp.read(chunk))
        _blocking_get(store, f"{pre}/done", timeout_ms,
                      "host 0's merge confirmation")
        return

    while True:
        blob = body_fp.read(chunk)
        if not blob:
            break
        out_fp.write(blob.decode())
    for h in range(1, num_processes):
        key = f"{pre}/{h}/nchunks"
        nc = int(_blocking_get(store, key, timeout_ms,
                               f"host {h}'s chunk count"))
        _delete(store, key)
        for c in range(nc):
            key = f"{pre}/{h}/{c}"
            out_fp.write(_blocking_get(store, key, timeout_ms,
                                       f"host {h}'s chunk {c}").decode())
            _delete(store, key)
            _set(store, f"{pre}/ack/{h}/{c}", "1")
    if store is not None:
        _set(store, f"{pre}/done", "1")


def shutdown_distributed() -> None:
    """Exit barrier, then leave the cluster (a no-op when it was never
    joined).

    A peer sets bye/<h> and is done: it never waits on host 0 again.
    Host 0 waits for every peer's bye key, under the gather timeout,
    before its process (which serves the store) may exit, so no peer
    still reading a confirmation finds the store gone.
    """
    global _cluster
    if _cluster is None:
        return
    store, pid, n = (_cluster[k] for k in ("store", "process_id", "num_processes"))
    timeout_ms = _gather_timeout_ms()
    if pid == 0:
        for h in range(1, n):
            _blocking_get(store, f"{_GATHER_PREFIX}/bye/{h}", timeout_ms,
                          f"host {h}'s exit")
    else:
        _set(store, f"{_GATHER_PREFIX}/bye/{pid}", "1")
    _cluster = None


def gather_counters(
    counters: dict[str, int], process_id: int, num_processes: int
) -> dict[str, int] | None:
    """Sum integer counters across hosts; host 0 gets the totals,
    other hosts get None. Newline-framed so the concatenated gather
    splits cleanly per host."""
    payload = (
        ",".join(f"{k}={v}" for k, v in sorted(counters.items())) + "\n"
    )
    merged = gather_ordered(payload.encode(), process_id, num_processes)
    if merged is None:
        return None
    totals = dict.fromkeys(counters, 0)
    for host_line in merged.decode().splitlines():
        for kv in host_line.split(","):
            if kv:
                k, v = kv.split("=")
                totals[k] = totals.get(k, 0) + int(v)
    return totals
