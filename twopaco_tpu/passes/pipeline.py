"""End-to-end junction enumeration pipeline (host orchestration).

The analogue of VertexEnumeratorImpl's constructor
(vertexenumerator.h:122-466): runs the multi-round, multi-pass pipeline
over cached window batches, producing

  - the junction dictionary: sorted canonical k-mer table (device +
    host mirrors), ids = rank+1;
  - the binary junction-position file (12-byte records, separators);
  - run statistics mirroring the reference's log counters.

Differences from the reference, by design (SURVEY.md §5, §7):
  - deterministic: canonical orientation is lexicographic min(kmer, rc),
    ids are sorted ranks, stub ids are assigned in input order — two runs
    produce byte-identical output;
  - the candidate set is verified by device sort + segmented reduction,
    not a mutexed hash table;
  - per-round candidate masks are kept as host-packed bitmaps instead of
    candidate_<round>.tmp files (vertexenumerator.h:485-490).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable, Iterable, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from twopaco_tpu import dna
from twopaco_tpu.io import fasta as fasta_io
from twopaco_tpu.io import junctions as junction_io
from twopaco_tpu.io import windows
from twopaco_tpu.ops import bloom
from twopaco_tpu.ops import pack
from twopaco_tpu.passes import kernels

INVALID_VERTEX = (1 << 63) - 1
STUB_ID_OFFSET = 42  # reference: vertexenumerator.h:419 (verticesCount + 42)


@dataclass(frozen=True)
class PipelineConfig:
    k: int
    filter_bits: int = 25  # f: Bloom slots = 2^f  (reference -f)
    hash_functions: int = 5  # q (reference -q)
    rounds: int = 1  # reference -r
    abundance: int = (1 << 64) - 1  # reference -a
    layout: str = "auto"  # bloom layout: auto|byte|bit
    positions_per_row: int = 2048  # must be a multiple of 8 (packed masks)
    rows_per_batch: int = 256
    engine: str = "sort"  # 'sort' (sort-join, default) | 'bloom'
    # max records per round sort (sort engine). Rounds exist to bound
    # device memory: a one-round 64 Mbase run at 2^26 peaks at 2.75 GB
    # (peak_bytes_in_use on an H100, build through judge). Each
    # round also pays a host sync, a fetch and its dispatches, so fewer,
    # bigger rounds are preferred while memory allows.
    sort_chunk: int = 1 << 26
    round_slack: float = 1.25  # round buffer slack over even split
    force_wide: bool = False  # u32-pair positions even below 4.2 Gbase
    # (the >=2^32-slot layout, vertexenumerator.h:935-958 analogue);
    # used to pre-compile big-run programs on small inputs

    def __post_init__(self) -> None:
        # k must be odd everywhere, not just in the CLI: even k breaks
        # canonicalization (palindromic k-mers tie with their own RC) and
        # the all-ones sentinel-word assumption for k % 16 == 0
        # (reference enforces the same, constructor.cpp:29-51)
        if self.k % 2 != 1:
            raise ValueError(f"k must be odd (got {self.k})")
        if self.k < 3:
            raise ValueError(f"k must be >= 3 (got {self.k})")

    def resolve_layout(self, shard_devices: int = 1) -> str:
        """Layout for the filter (shard) each device will hold.

        shard_devices > 1 = the dist-bloom engine: each device owns
        ceil(2^f / D) slots, so e.g. -f 38 fits the bit layout on an
        8-device mesh even though it exceeds the single-chip cap."""
        slots = -(-(1 << self.filter_bits) // shard_devices)
        if self.layout != "auto":
            bloom.check_layout_slots(slots, self.layout)
            return self.layout
        return bloom.choose_layout_slots(slots)

    def pass_config(
        self, *, filterless: bool = False, shard_devices: int = 1
    ) -> kernels.PassConfig:
        """filterless: the sort-join engines never allocate a Bloom
        filter — skip the layout capacity check so any -f (it only
        sets the hash width there) is accepted."""
        return kernels.PassConfig(
            k=self.k,
            q=self.hash_functions,
            f=self.filter_bits,
            layout="byte" if filterless else self.resolve_layout(
                shard_devices
            ),
            positions_per_row=self.positions_per_row,
            rows_per_batch=self.rows_per_batch,
        )

    def window_config(self) -> windows.WindowConfig:
        return windows.WindowConfig(
            k=self.k,
            positions_per_row=self.positions_per_row,
            rows_per_batch=self.rows_per_batch,
        )


@dataclass
class RunStats:
    rounds: list[dict] = field(default_factory=list)
    occurrences: int = 0
    distinct_junctions: int = 0
    stub_ids: int = 0
    total_positions: int = 0
    timings: dict = field(default_factory=dict)


class Enumerator:
    """Queryable junction dictionary (reference VertexEnumerator,
    vertexenumerator.h:23-35)."""

    def __init__(self, junction_words: np.ndarray, k: int, stats: RunStats):
        self.k = k
        self.junction_words = junction_words  # (J, w) uint32, sorted
        self._keys = dna.words_to_bytes_keys(junction_words)
        self.stats = stats

    @property
    def vertices_count(self) -> int:
        return int(self.junction_words.shape[0])

    def _lookup_words(self, words: np.ndarray) -> np.ndarray:
        """Rank of each packed k-mer row of `words` (n, w), -1 if absent."""
        if len(self._keys) == 0:
            return np.full(len(words), -1, np.int64)
        keys = dna.words_to_bytes_keys(words)
        i = np.searchsorted(self._keys, keys)
        hit = self._keys[np.minimum(i, len(self._keys) - 1)] == keys
        return np.where(hit, i, -1)

    def get_ids(self, vertices: list[str]) -> np.ndarray:
        """get_id of every k-mer in `vertices`, as one int64 array (the
        self-test looks up every junction of every run)."""
        codes = dna.encode("".join(vertices)).reshape(len(vertices), self.k)
        if codes.max(initial=0) >= 4:
            raise ValueError("k-mer must be over ACGT only")
        fwd = self._lookup_words(dna.pack_kmers(codes, self.k))
        rc = self._lookup_words(dna.pack_kmers((3 - codes)[:, ::-1], self.k))
        return np.where(
            fwd >= 0, fwd + 1, np.where(rc >= 0, -(rc + 1), INVALID_VERTEX)
        ).astype(np.int64)

    def get_id(self, vertex: str) -> int:
        """+-(rank+1) for either strand, INVALID_VERTEX if absent
        (reference BifurcationStorage::GetId, bifurcationstorage.h:100)."""
        assert len(vertex) == self.k
        return int(self.get_ids([vertex])[0])


def _split_rounds(hist: np.ndarray, rounds: int, bin_pow: int) -> list[tuple[int, int]]:
    """Greedy equal-mass split of the hash space into `rounds` inclusive
    uint32 intervals (reference vertexenumerator.h:206-250)."""
    if rounds <= 1:
        return [(0, 0xFFFFFFFF)]
    total = int(hist.sum())
    target = total / rounds
    bounds = []
    acc = 0
    low_bin = 0
    for b in range(len(hist)):
        acc += int(hist[b])
        if acc >= target and len(bounds) < rounds - 1:
            bounds.append((low_bin, b))
            low_bin = b + 1
            acc = 0
    bounds.append((low_bin, len(hist) - 1))
    shift = 32 - bin_pow
    out = []
    for lo_b, hi_b in bounds:
        if lo_b >= len(hist):
            # the greedy boundary consumed every bin already: this round
            # is empty — use an inverted (always-false) interval so the
            # uint32 bounds stay valid and rounds remain disjoint
            out.append((1, 0))
            continue
        low = lo_b << shift
        high = ((hi_b + 1) << shift) - 1 if hi_b + 1 < len(hist) else 0xFFFFFFFF
        out.append((low, high))
    return out


def _next_pow2(n: int) -> int:
    return 1 << max(10, (n - 1).bit_length())


def _bucket_cap(count: int, hard_max: int) -> int:
    """Capacity bucket (pow2, >= count) so few distinct shapes compile."""
    return min(_next_pow2(max(count, 1)), hard_max)


def _input_fingerprint(input_paths, sequences) -> str:
    """Identity of the run's input for checkpoint validation: file
    paths+sizes+mtimes when reading from disk, a content hash of the
    encoded sequences otherwise."""
    import hashlib
    import os

    h = hashlib.blake2b(digest_size=16)
    if input_paths is not None:
        for p in input_paths:
            st = os.stat(p)
            h.update(
                f"{os.path.abspath(p)}:{st.st_size}:{st.st_mtime_ns};".encode()
            )
    else:
        for sid, codes in sequences:
            h.update(f"{sid}:{len(codes)}:".encode())
            h.update(np.ascontiguousarray(codes, np.uint8).tobytes())
    return h.hexdigest()


class RoundCheckpoint:
    """Round-boundary checkpointing shared by both engines: each
    completed round's arrays + stats land in <dir>/round_<r>.npz,
    guarded by a meta.json of the run parameters and an input
    fingerprint (a mismatch invalidates the checkpoint rather than
    resuming wrongly). The reference keeps intermediate files but has
    no resume (SURVEY.md §5); rounds are deterministic here, so
    completed ones can be reloaded verbatim."""

    def __init__(self, directory, meta: dict, read_only: bool = False):
        """read_only: skip the meta write + stale-file wipe — the mode
        of non-writer processes in a multi-process run, where exactly
        one process (the writer) owns the directory's mutations and a
        barrier orders them before anyone reads (parallel/distpipe)."""
        self.dir = directory
        if directory is None:
            return
        import json
        import os

        os.makedirs(directory, exist_ok=True)
        self.meta = meta
        if read_only:
            return
        meta_path = os.path.join(directory, "meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                if json.load(f) != self.meta:
                    for fn in os.listdir(directory):
                        if fn.startswith("round_") or fn == "meta.json":
                            os.remove(os.path.join(directory, fn))
        with open(meta_path, "w") as f:
            json.dump(self.meta, f)

    def _path(self, r: int) -> str:
        import os

        return os.path.join(self.dir, f"round_{r}.npz")

    def has_round(self, r: int) -> bool:
        import os

        return self.dir is not None and os.path.exists(self._path(r))

    def load_round(self, r: int):
        """-> (arrays dict, rstats dict) or None if not checkpointed."""
        if self.dir is None:
            return None
        import json
        import os

        p = self._path(r)
        if not os.path.exists(p):
            return None
        z = np.load(p, allow_pickle=False)
        rstats = json.loads(str(z["stats"]))
        return {k: z[k] for k in z.files if k != "stats"}, rstats

    def save_round(self, r: int, rstats, **arrays) -> None:
        if self.dir is None:
            return
        import json
        import os

        tmp = self._path(r) + ".tmp.npz"  # .npz suffix: savez won't append
        np.savez(tmp, stats=np.asarray(json.dumps(rstats)), **arrays)
        os.replace(tmp, self._path(r))


class _MaskStore:
    """Per-round candidate-mask retention for the bloom engine's pass 4,
    with a disk spill above a byte budget — the analogue of the
    reference's per-round candidate_<round>.tmp mask files
    (vertexenumerator.h:485-490,676-685): rounds x n_slots/8 bits of
    packed masks would otherwise stay resident (≈2.5 GB at 5 Gbase x
    r=4). Spilled rounds are written once and mmap-read during pass 4."""

    def __init__(self, tmpdir: str | None, est_bytes: int):
        import tempfile

        budget = int(
            os.environ.get("TWOPACO_MASK_SPILL_BYTES", str(1 << 30))
        )
        self.spill = est_bytes > budget
        self.dir = None
        self._rounds: list = []  # per round: list[np.ndarray] | path
        if self.spill:
            self.dir = tempfile.mkdtemp(
                prefix="twopaco_masks_", dir=tmpdir
            )

    def add_round(self, masks: list[np.ndarray]) -> None:
        if not self.spill or not masks:
            self._rounds.append(masks)
            return
        path = os.path.join(self.dir, f"candidate_{len(self._rounds)}.npy")
        np.save(path, np.stack(masks))
        self._rounds.append(path)

    def n_rounds(self) -> int:
        return len(self._rounds)

    def round(self, r: int):
        """-> indexable per-batch masks of round r (list or mmap array)."""
        entry = self._rounds[r]
        if isinstance(entry, str):
            return np.load(entry, mmap_mode="r")
        return entry

    def cleanup(self) -> None:
        if self.dir is not None:
            import shutil

            shutil.rmtree(self.dir, ignore_errors=True)
            self.dir = None
            self._rounds = []


def _present(sorted_arr: np.ndarray, targets: np.ndarray) -> np.ndarray:
    """Element-of test for each target against a sorted array."""
    if len(sorted_arr) == 0:
        return np.zeros(len(targets), bool)
    idx = np.minimum(
        np.searchsorted(sorted_arr, targets), len(sorted_arr) - 1
    )
    return sorted_arr[idx] == targets


def emit_junctions(
    out_path: str,
    batches,
    occ_pos: np.ndarray,
    occ_ids: np.ndarray,
    table_len: int,
    P: int,
    timings: dict | None = None,
) -> tuple[int, int]:
    """Pass-4 output, fully vectorized: stub synthesis + separator
    insertion as numpy array ops instead of per-row Python.

    Semantics are the reference EdgeConstructionWorker's
    (vertexenumerator.h:927-958): every sequence's first/last vertex
    position gets a fresh stub id when it isn't a resolved junction --
    except stub ids here are deterministic, assigned in input order
    (stream order), not worker-arrival order.

    occ_pos: sorted global flat positions (row * P + col) of resolved
    junction occurrences; occ_ids: their signed ids. Returns
    (records_written, stub_count).
    """
    t0 = time.time()
    seq_id = np.concatenate([b.seq_id for b in batches]).astype(np.int64)
    pos0 = np.concatenate([b.pos0 for b in batches])
    valid = np.concatenate([b.valid for b in batches]).astype(np.int64)
    n_pos = np.concatenate([b.n_pos for b in batches])
    dump = os.environ.get("TWOPACO_DUMP_EMIT")
    if dump:  # offline emit profiling on real-run inputs
        np.savez(
            dump, occ_pos=occ_pos, occ_ids=occ_ids, seq_id=seq_id,
            pos0=pos0, valid=valid, n_pos=n_pos,
            table_len=np.int64(table_len), P=np.int64(P),
        )
    n_rows = len(seq_id)
    rows = np.arange(n_rows, dtype=np.int64)
    occ_pos = occ_pos.astype(np.int64, copy=False)
    live = seq_id >= 0

    # stubs at unresolved sequence endpoints, in stream order: a
    # sequence's first position is strictly before any of its resolved
    # occurrences (their in-row cols are >= 1 when the stub fires) and
    # the last strictly after, so (flat position) order IS stream order
    first_flat = rows * P
    pre = live & (pos0 == 1) & ~_present(occ_pos, first_flat)
    j_last = n_pos - pos0
    is_last_row = live & (j_last >= 0) & (j_last < valid)
    last_flat = rows * P + np.where(is_last_row, j_last, 0)
    post = (
        is_last_row
        & ~_present(occ_pos, last_flat)
        & ~(pre & (j_last == 0))  # 1-position sequence: one stub only
    )
    stub_flat = np.sort(np.concatenate([first_flat[pre], last_flat[post]]))
    stub_ids = (
        np.arange(len(stub_flat), dtype=np.int64)
        + table_len
        + STUB_ID_OFFSET
    )

    # occ_pos and stub_flat are each sorted and disjoint (a stub exists
    # only where no occurrence does): the merged stream is occurrence
    # segments with single stub records spliced between them
    ins = np.searchsorted(occ_pos, stub_flat, side="left")
    occ_ids = occ_ids.astype(np.int64, copy=False)
    if timings is not None:
        timings["emit_stub"] = time.time() - t0
    t0 = time.time()

    # chunked map+write: constant-size chunks recycle the same warm
    # heap blocks — materializing the whole stream (several GB at
    # pangenome occurrence densities) re-faults cold pages at ~10-30
    # s/GB on this VM and dominated 285-Mbase runs
    CH = 1 << 24
    t_map = 0.0
    p_shift = P.bit_length() - 1 if P & (P - 1) == 0 else None

    def map_chunk(fv, iv):
        nonlocal t_map
        tm = time.time()
        if p_shift is not None:  # int64 division runs ~25M/s, shifts ~500M/s
            row_of = fv >> p_shift
            col = fv & (P - 1)
        else:
            row_of = fv // P
            col = fv - row_of * P
        out_chr = seq_id[row_of]
        out_pos = (pos0[row_of] - 1 + col).astype(np.uint32)
        t_map += time.time() - tm
        return out_chr, out_pos, iv

    with junction_io.ChunkWriter(out_path) as w:
        seg_start = np.concatenate([[0], ins])
        seg_end = np.concatenate([ins, [len(occ_pos)]])
        for si in range(len(seg_start)):
            for a in range(seg_start[si], seg_end[si], CH):
                b = min(a + CH, seg_end[si])
                w.write(*map_chunk(occ_pos[a:b], occ_ids[a:b]))
            if si < len(stub_flat):
                w.write(
                    *map_chunk(
                        stub_flat[si : si + 1], stub_ids[si : si + 1]
                    )
                )
    if timings is not None:
        timings["emit_map"] = t_map
        timings["emit_write"] = time.time() - t0 - t_map
    return len(occ_pos) + len(stub_flat), len(stub_flat)




def emit_junctions_packed(
    out_path: str,
    batches,
    keys: np.ndarray,
    table_len: int,
    P: int,
    timings: dict | None = None,
    id_bits: int = 32,
) -> tuple[int, int]:
    """emit_junctions over a PACKED occurrence stream: keys (sorted
    u64) = flat_pos << id_bits | (signed id + 2^(id_bits-1)). One
    array instead of two int64 ones — junction-dense pangenome runs
    (e.g. 62-strain E. coli, 126M occurrences) spent minutes
    faulting/concatenating the unpacked form. Requires flat positions
    < 2^(64-id_bits) and |id| < 2^(id_bits-1) (the caller falls back
    to emit_junctions otherwise)."""
    t0 = time.time()
    ib = np.uint64(id_bits)
    id_bias = np.int64(1) << (id_bits - 1)
    id_mask = np.uint64((1 << id_bits) - 1)
    seq_id = np.concatenate([b.seq_id for b in batches]).astype(np.int64)
    pos0 = np.concatenate([b.pos0 for b in batches])
    valid = np.concatenate([b.valid for b in batches]).astype(np.int64)
    n_pos = np.concatenate([b.n_pos for b in batches])
    n_rows = len(seq_id)
    rows = np.arange(n_rows, dtype=np.int64)
    live = seq_id >= 0

    def present(flats):
        # an occurrence at flat f has key in [f<<id_bits, (f+1)<<id_bits)
        if len(keys) == 0:
            return np.zeros(len(flats), bool)
        idx = np.minimum(
            np.searchsorted(keys, flats.astype(np.uint64) << ib),
            len(keys) - 1,
        )
        return (keys[idx] >> ib).astype(np.int64) == flats

    first_flat = rows * P
    pre = live & (pos0 == 1) & ~present(first_flat)
    j_last = n_pos - pos0
    is_last_row = live & (j_last >= 0) & (j_last < valid)
    last_flat = rows * P + np.where(is_last_row, j_last, 0)
    post = (
        is_last_row
        & ~present(last_flat)
        & ~(pre & (j_last == 0))
    )
    stub_flat = np.sort(np.concatenate([first_flat[pre], last_flat[post]]))
    stub_ids = (
        np.arange(len(stub_flat), dtype=np.int64)
        + table_len
        + STUB_ID_OFFSET
    )
    ins = np.searchsorted(
        keys, stub_flat.astype(np.uint64) << ib, side="left"
    )
    if timings is not None:
        timings["emit_stub"] = time.time() - t0
    t0 = time.time()

    CH = 1 << 24
    t_map = 0.0

    p_shift = P.bit_length() - 1 if P & (P - 1) == 0 else None

    def split_key(kv):
        """(flat positions, signed ids) from a key chunk."""
        if id_bits == 32:
            # u32 halves through a view (little-endian: [0]=id,
            # [1]=pos) — in-place u64 ufuncs measured far slower
            halves = kv.view(np.uint32).reshape(-1, 2)
            return halves[:, 1], halves[:, 0].astype(np.int64) - id_bias
        fv = (kv >> ib).view(np.int64)
        iv = (kv & id_mask).view(np.int64) - id_bias
        return fv, iv

    def map_keys(kv):
        nonlocal t_map
        tm = time.time()
        fv, iv = split_key(kv)
        if p_shift is not None:
            # int64 division runs ~25M/s, shifts ~500M/s
            row_of = (fv >> fv.dtype.type(p_shift)).astype(np.int64)
            col = fv & fv.dtype.type(P - 1)
        else:
            fv64 = fv.astype(np.int64)
            row_of = fv64 // P
            col = (fv64 - row_of * P).astype(np.uint32)
        out_chr = seq_id[row_of]
        out_pos = pos0[row_of] - 1 + col
        t_map += time.time() - tm
        return out_chr, out_pos, iv

    def map_flat(fv, iv):
        row_of = fv // P
        return (
            seq_id[row_of],
            (pos0[row_of] - 1 + (fv - row_of * P)).astype(np.uint32),
            iv,
        )

    # pipeline decode against write: numpy releases the GIL for the
    # big ufuncs, so chunk i+1 decodes while chunk i's bytes flush
    from concurrent.futures import ThreadPoolExecutor

    def chunk_iter():
        seg_start = np.concatenate([[0], ins])
        seg_end = np.concatenate([ins, [len(keys)]])
        for si in range(len(seg_start)):
            for a in range(seg_start[si], seg_end[si], CH):
                b = min(a + CH, seg_end[si])
                yield lambda a=a, b=b: map_keys(keys[a:b])
            if si < len(stub_flat):
                yield lambda si=si: map_flat(
                    stub_flat[si : si + 1], stub_ids[si : si + 1]
                )

    with junction_io.ChunkWriter(out_path) as w, ThreadPoolExecutor(
        1
    ) as pool:
        fut = None
        for thunk in chunk_iter():
            nxt = pool.submit(thunk)
            if fut is not None:
                w.write(*fut.result())
            fut = nxt
        if fut is not None:
            w.write(*fut.result())
    if timings is not None:
        timings["emit_map"] = t_map
        timings["emit_write"] = time.time() - t0 - t_map
    return len(keys) + len(stub_flat), len(stub_flat)


def build_junctions(
    input_paths: Sequence[str] | None,
    config: PipelineConfig,
    out_path: str | None = None,
    sequences: Sequence[tuple[int, np.ndarray]] | None = None,
    log: Callable[[str], None] = lambda s: None,
    profile_dir: str | None = None,
    checkpoint_dir: str | None = None,
    tmpdir: str | None = None,
) -> Enumerator:
    """Run the full pipeline; returns the Enumerator (junction dict).

    input_paths: FASTA files (reference CLI order) — or pass `sequences`
    directly as [(seq_id, codes uint8)]. profile_dir: write a
    jax.profiler trace of the device passes there (the reference's only
    observability is coarse per-pass wall clock, SURVEY.md §5; we get
    real traces). checkpoint_dir: resume completed rounds from / save
    them to this directory (both engines checkpoint at round
    boundaries; a changed input or parameter set invalidates it).
    """
    if profile_dir is not None:
        import jax.profiler

        with jax.profiler.trace(profile_dir):
            return build_junctions(
                input_paths, config, out_path, sequences, log, None,
                checkpoint_dir, tmpdir,
            )
    if config.engine == "sort":
        from twopaco_tpu.passes import sortpipe

        return sortpipe.build_junctions_sorted(
            input_paths, config, out_path, sequences, log, checkpoint_dir
        )
    if config.engine in ("dist", "dist-bloom"):
        from twopaco_tpu.parallel.distpipe import build_junctions_dist

        return build_junctions_dist(
            input_paths, config, None, out_path, sequences, log,
            checkpoint_dir=checkpoint_dir,
            bloom_gate=config.engine == "dist-bloom",
        )
    cfg = config.pass_config()
    wcfg = config.window_config()
    stats = RunStats()
    t_start = time.time()

    if sequences is None:
        sequences = [
            (sid, codes)
            for sid, _hdr, codes in fasta_io.read_all_records(input_paths)
        ]
    batches = list(
        windows.iter_window_batches(iter(sequences), wcfg)
    )
    stats.total_positions = sum(int(b.valid.sum()) for b in batches)
    log(
        f"Threads = XLA\nVertex length = {config.k}\n"
        f"Hash functions = {config.hash_functions}\n"
        f"Filter size = {1 << config.filter_bits} ({cfg.layout} layout)\n"
        f"Capacity = {cfg.w} words\nPositions = {stats.total_positions}"
    )

    # 2-bit packed + N bitmask transfer form (see ops/pack.py)
    dev_batches = [
        (
            tuple(map(jnp.asarray, pack.pack_codes_host(b.codes))),
            jnp.asarray(b.valid),
        )
        for b in batches
    ]

    # ---- round split (reference InitialFilterFillerWorker analogue) ----
    bin_pow = 16
    if config.rounds > 1:
        t0 = time.time()
        if os.environ.get("TWOPACO_UNIFORM_SPLIT", "1") != "0":
            # near-uniform Buzhash values make a uniform hash-space
            # split as balanced as the counted one (see the sort
            # engine); rounds here only bound filter-probe work, so
            # imbalance costs time, never correctness
            hist = np.ones(1 << bin_pow, np.int64)
        else:
            hist = np.zeros(1 << bin_pow, np.int64)
            for codes_d, valid_d in dev_batches:
                hist += np.asarray(
                    kernels.histogram_vertex_hashes(
                        codes_d, valid_d, cfg=cfg, bin_pow=bin_pow
                    )
                )
        intervals = _split_rounds(hist, config.rounds, bin_pow)
        stats.timings["split"] = time.time() - t0
        log(f"Splitting the input kmers set... {intervals}")
    else:
        intervals = [(0, 0xFFFFFFFF)]

    # ---- rounds: fill -> mark -> verify --------------------------------
    # round-boundary checkpoint/resume (same guard scheme as the sort
    # engine): a round's outputs are its junction words + per-batch
    # candidate masks/counts (needed again by pass 4)
    ckpt = RoundCheckpoint(
        checkpoint_dir,
        dict(
            k=config.k,
            abundance=config.abundance,
            filter_bits=config.filter_bits,
            hash_functions=config.hash_functions,
            engine="bloom",
            intervals=[list(map(int, iv)) for iv in intervals],
            fingerprint=_input_fingerprint(input_paths, sequences)
            if checkpoint_dir is not None
            else None,
            version=1,
        ),
    )
    all_junction_words: list[np.ndarray] = []
    # per-round packed candidate masks, disk-spilled above a byte budget
    # (reference candidate_<round>.tmp, vertexenumerator.h:485-490)
    mask_store = _MaskStore(
        tmpdir,
        est_bytes=len(intervals) * len(batches) * cfg.B * cfg.P // 8,
    )
    round_counts: list[list[int]] = []  # [round][batch] candidate counts
    for r, (low, high) in enumerate(intervals):
        restored = ckpt.load_round(r)
        if restored is not None:
            arrays, rstats = restored
            all_junction_words.append(arrays["junc_words"])
            mask_store.add_round(list(arrays["masks"]))
            round_counts.append([int(c) for c in arrays["counts"]])
            stats.rounds.append(rstats)
            log(f"Round {r}: restored from checkpoint")
            continue
        low_d, high_d = jnp.uint32(low), jnp.uint32(high)
        log(f"Round {r}, {low}:{high}")

        t0 = time.time()
        filt = bloom.make_filter(cfg.f, cfg.layout)
        for codes_d, valid_d in dev_batches:
            filt = kernels.pass1_fill(filt, codes_d, valid_d, low_d, high_d, cfg=cfg)
        filt.block_until_ready()
        t_fill = time.time() - t0

        t0 = time.time()
        marks_count = 0
        rec_words: list[np.ndarray] = []
        rec_in: list[np.ndarray] = []
        rec_out: list[np.ndarray] = []
        masks_here: list[np.ndarray] = []
        counts_here: list[int] = []
        # dispatch the whole mark pass asynchronously; only the 8-byte
        # counts sync before extraction (which is capacity-bucketed so a
        # handful of executables cover every batch)
        pending = []
        for codes_d, valid_d in dev_batches:
            packed, cnt = kernels.pass2_mark(
                filt, codes_d, valid_d, low_d, high_d, cfg=cfg
            )
            pending.append((codes_d, packed, cnt))
        # one fetch for every batch's count (a scalar RPC each otherwise)
        counts_now = [
            int(c) for c in np.asarray(
                jnp.stack([cnt for _c, _p, cnt in pending])
            )
        ]
        # one extraction cap for every batch (per-batch buckets mint
        # fresh compiles when counts drift across runs)
        cap = _bucket_cap(max(counts_now + [1]), cfg.B * cfg.P)
        pending2 = []
        for (codes_d, packed, _cnt), count in zip(pending, counts_now):
            words, in_c, out_c, _c = kernels.extract_records(
                codes_d, packed, cfg=cfg, cap=cap
            )
            pending2.append((packed, words, in_c, out_c, count))
        for packed, words, in_c, out_c, count in pending2:
            marks_count += count
            rec_words.append(np.asarray(words)[:count])
            rec_in.append(np.asarray(in_c)[:count])
            rec_out.append(np.asarray(out_c)[:count])
            masks_here.append(np.asarray(packed))
            counts_here.append(count)
        round_counts.append(counts_here)
        del filt, pending, pending2
        t_mark = time.time() - t0

        # ---- exact verification (device sort + segmented reduce) -------
        t0 = time.time()
        m_total = sum(len(x) for x in rec_words)
        if m_total:
            m_pad = _next_pow2(m_total)
            words = np.full((m_pad, cfg.w), 0xFFFFFFFF, np.uint32)
            in_c = np.zeros(m_pad, np.uint8)
            out_c = np.zeros(m_pad, np.uint8)
            words[:m_total] = np.concatenate(rec_words)
            in_c[:m_total] = np.concatenate(rec_in)
            out_c[:m_total] = np.concatenate(rec_out)
            sw, keep_first, n_groups, n_junc = kernels.verify_records(
                jnp.asarray(words),
                jnp.asarray(in_c),
                jnp.asarray(out_c),
                jnp.uint64(config.abundance),
                w=cfg.w,
            )
            keep_first = np.asarray(keep_first)
            junc_words = np.asarray(sw)[keep_first]
            n_groups, n_junc = int(n_groups), int(n_junc)
        else:
            junc_words = np.zeros((0, cfg.w), np.uint32)
            n_groups = n_junc = 0
        all_junction_words.append(junc_words)
        t_verify = time.time() - t0

        stats.rounds.append(
            dict(
                low=low,
                high=high,
                marks=marks_count,
                hash_table_size=n_groups,
                true_junctions=n_junc,
                false_positives=n_groups - n_junc,
                t_fill=t_fill,
                t_mark=t_mark,
                t_verify=t_verify,
            )
        )
        log(
            f"Pass\tFilling\tFiltering\n1\t{t_fill:.1f}\t{t_mark:.1f}\n"
            f"2\t{t_verify:.1f}\nTrue junctions = {n_junc}\n"
            f"False junctions = {n_groups - n_junc}\n"
            f"Hash table size = {n_groups}\nCandidate marks count = {marks_count}"
        )
        ckpt.save_round(
            r,
            stats.rounds[-1],
            junc_words=junc_words,
            masks=np.stack(masks_here) if masks_here else np.zeros(
                (0, 0, 0), np.uint32
            ),
            counts=np.asarray(counts_here, np.int64),
        )
        mask_store.add_round(masks_here)
        del masks_here

    # ---- junction dictionary ------------------------------------------
    t0 = time.time()
    cat = np.concatenate(all_junction_words) if all_junction_words else np.zeros((0, cfg.w), np.uint32)
    if len(cat):
        keys = dna.words_to_bytes_keys(cat)
        order = np.argsort(keys, kind="stable")
        cat = cat[order]
        keys = keys[order]
        uniq = np.ones(len(cat), bool)
        uniq[1:] = keys[1:] != keys[:-1]
        table = np.ascontiguousarray(cat[uniq])
    else:
        table = cat
    stats.distinct_junctions = len(table)
    stats.timings["dict"] = time.time() - t0
    log(f"Reallocating bifurcations time: {stats.timings['dict']:.1f}")

    enum = Enumerator(table, config.k, stats)

    # ---- pass 4: id assignment + ordered output ------------------------
    if out_path is not None:
        t0 = time.time()
        table_d = jnp.asarray(table)
        bound_max = 1
        for col in zip(*round_counts):  # per-batch counts across rounds
            bound_max = max(bound_max, sum(col))
        # ONE cap for every batch: per-batch buckets minted a fresh
        # pass4 compile whenever a batch crossed a pow2 boundary between
        # runs
        cap = _bucket_cap(bound_max, cfg.B * cfg.P)
        # per-round mask views (possibly mmap-backed spill files); the
        # OR is streamed per batch so only one batch's merged mask is
        # host-resident at a time
        rounds_masks = [
            mask_store.round(r) for r in range(mask_store.n_rounds())
        ]
        pending = []
        for bi, (codes_d, valid_d) in enumerate(dev_batches):
            packed = np.array(rounds_masks[0][bi])
            for rm in rounds_masks[1:]:
                packed |= rm[bi]
            pos_f, ids_f, cnt = kernels.pass4_lookup(
                codes_d, jnp.asarray(packed), valid_d, table_d,
                cfg=cfg, cap=cap,
            )
            pending.append((pos_f, ids_f, cnt))
        del rounds_masks
        mask_store.cleanup()
        stats.timings["pass4_dispatch"] = time.time() - t0
        log(f"Pass 4 cap: {cap}")
        t0 = time.time()
        all_pos: list[np.ndarray] = []
        all_ids: list[np.ndarray] = []
        cnts = np.asarray(jnp.stack([cnt for _p, _i, cnt in pending]))
        for b, (pos_f, ids_f, _c), cnt in zip(batches, pending, cnts):
            cnt = int(cnt)
            # batch-local flat positions -> global (row * P + col)
            all_pos.append(
                np.asarray(pos_f)[:cnt].astype(np.int64) + b.row0 * cfg.P
            )
            all_ids.append(np.asarray(ids_f)[:cnt].astype(np.int64))
        stats.timings["pass4_fetch"] = time.time() - t0
        t0 = time.time()
        occ_pos = (
            np.concatenate(all_pos) if all_pos else np.zeros(0, np.int64)
        )
        occ_ids = (
            np.concatenate(all_ids) if all_ids else np.zeros(0, np.int64)
        )
        occurrences, n_stubs = emit_junctions(
            out_path, batches, occ_pos, occ_ids, len(table), cfg.P,
            timings=stats.timings,
        )
        stats.occurrences = occurrences
        stats.stub_ids = n_stubs
        stats.timings["emit"] = time.time() - t0
        log(
            f"True marks count: {occurrences}\n"
            f"Edges construction time: {stats.timings['emit']:.1f}"
        )

    mask_store.cleanup()  # no-op if pass 4 already cleaned up
    stats.timings["total"] = time.time() - t_start
    log(f"Distinct junctions = {enum.vertices_count}")
    return enum
