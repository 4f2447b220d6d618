"""The streaming batch backend on the card.

Counterpart of the reference's ``extractors/tpu_batch.py:TpuBatchBackend``:
a **streaming** dedup stage.  Extracted article records are submitted one
by one, buffered into batches of ``cfg.batch_size``, hashed on the card
(``NearDupEngine.signatures_and_keys``: one ``minhash_fold_segments``
launch per batch, then the keys epilogue) and joined on the host against
a stream index that lives across batches.  Decisions are annotated onto
the records (``dup_of``/``near_dup_of``), never destructive.

Three stream indexes run, as in the reference:

- ``exact`` (the default): the seen keys, and every kept record's
  signature and coarse + fine band keys in a host dict; a band-key hit
  is confirmed by signature agreement (float64 ``np.mean`` against
  ``sim_threshold``, plus ``fine_margin`` for a fine-only hit), and dup
  marks name the kept record's key;
- ``bloom``: one Bloom filter per band over 64-bit wide band keys
  (``utils.bloom``), and a one-band filter over a 64-bit url hash: fixed
  memory, dup marks are ``BLOOM_SENTINEL``;
- ``persist``: two persistent indexes (``index.store.PersistentIndex``)
  under ``index_dir``, ``bands/`` over the 64-bit wide band keys and
  ``urls/`` over the url hash, sharing one doc-id space; dup marks are
  ``doc:<id>`` (:func:`index_ref`), stable across restarts and resolved
  to urls by the docmap (``lookup_names``).  Every record gets a doc id;
  the url stage only probes, and its postings land after the band
  postings, so a crash never leaves a url posted without its bands.

The exact and bloom indexes checkpoint to an npz that the reference
package reads, and that this one reads from it (same member names, dtypes
and config fingerprint); the persist index is durable as it goes, its
directory shared with the reference, and imports an exact-mode npz once.

Not ported yet, and raising ``NotImplementedError``: the remote index
fleet (``index_fleet``, ROADMAP item 9c).  The reference's telemetry
gauges, decision counts and journal and quarantine counter come with item
14 and are left out here.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from advanced_scrapper_tpu_torch.config import DedupConfig
from advanced_scrapper_tpu_torch.core.hashing import make_params
from advanced_scrapper_tpu_torch.ops.lsh import candidate_keys
from advanced_scrapper_tpu_torch.pipeline.clock import StageClock
from advanced_scrapper_tpu_torch.ops.rerank import band_keys_wide_host
from advanced_scrapper_tpu_torch.pipeline.dedup import SLICE_FLEET, NearDupEngine
from advanced_scrapper_tpu_torch.utils.bloom import BloomBandIndex, hash_key64, pack_keys64

#: dup marks in bloom mode: membership is known, the target is not
BLOOM_SENTINEL = "(bloom)"

#: dup marks in persist mode name a stable doc id (``doc:<id>``), which the
#: index's docmap resolves to a url; the match may come from an earlier run
INDEX_REF_PREFIX = "doc:"


def index_ref(doc_id: int) -> str:
    return f"{INDEX_REF_PREFIX}{int(doc_id)}"


class IndexFingerprintError(ValueError):
    """Stream-index checkpoint written under a different dedup config.

    Its own type so that the resume path tells it apart from numpy's
    ValueErrors on a corrupted archive: a mismatched config is an operator
    error and stays loud, a corrupted file is quarantined."""


def _key_of(rec: dict, field: str) -> str:
    """The one key normalisation: missing, None and empty all mean keyless."""
    return str(rec.get(field) or "")


@dataclass
class BatchStats:
    submitted: int = 0
    batches: int = 0
    exact_dups: int = 0
    near_dups: int = 0
    kept: int = 0


class TpuBatchBackend:
    """Streaming exact + near-dup annotator over fixed-size batches.

    ``device=None`` means ``"cuda"`` and raises without a card; pass
    ``device="cpu"`` for the plain PyTorch versions.  ``exact_stage=False``
    skips the exact-key filter, the keys still serving as near-dup
    targets (for keys unique by construction).  ``index_dir`` (persist
    mode) overrides ``cfg.index_dir``."""

    def __init__(
        self,
        cfg: DedupConfig | None = None,
        *,
        text_field: str = "article",
        key_field: str = "url",
        sink: Callable[[dict], None] | None = None,
        exact_stage: bool = True,
        index_dir: str | None = None,
        device: str | torch.device | None = None,
    ):
        self.cfg = cfg or DedupConfig()
        if self.cfg.index_fleet:
            raise NotImplementedError(
                f"index_fleet is not ported yet; it comes in {SLICE_FLEET}"
            )
        if self.cfg.stream_index not in ("exact", "bloom", "persist"):
            raise ValueError(
                f"unknown stream_index {self.cfg.stream_index!r}; "
                "use exact|bloom|persist"
            )
        self.params = make_params(
            num_perm=self.cfg.num_perm,
            num_bands=self.cfg.num_bands,
            shingle_k=self.cfg.shingle_k,
            seed=self.cfg.seed,
        )
        self.engine = NearDupEngine(self.cfg, self.params, device=device)
        self.device = self.engine.device
        self.text_field = text_field
        self.key_field = key_field
        self.sink = sink
        self.exact_stage = exact_stage
        self._buffer: list[dict] = []
        self._bloom_mode = self.cfg.stream_index == "bloom"
        self._persist_mode = self.cfg.stream_index == "persist"
        if self._persist_mode:
            self._index_dir = index_dir or self.cfg.index_dir
            if not self._index_dir:
                raise ValueError(
                    "stream_index='persist' needs an index directory "
                    "(cfg.index_dir or the index_dir argument)"
                )
        #: host seconds (and on the card, device times) of the last batch's
        #: stages: ``exact_stage``, ``signatures_and_keys`` and ``join``
        #: (``bloom`` in bloom mode, ``persist`` in persist mode); the
        #: engine's ``last_clock`` breaks the middle one down
        self.last_clock = StageClock(self.device)
        self._reset_stream_state()

    def _reset_stream_state(self) -> None:
        """(Re)initialise all cross-batch state: at construction, and on
        the quarantine path, which must drop a partly loaded checkpoint."""
        if self._bloom_mode:
            self._bloom = BloomBandIndex(
                self.cfg.num_bands,
                bits=self.cfg.bloom_bits,
                num_hashes=self.cfg.bloom_hashes,
                seed=self.cfg.seed,
            )
            # the exact-url stage as a 1-band filter over a url hash
            self._bloom_urls = BloomBandIndex(
                1, bits=self.cfg.bloom_bits, num_hashes=self.cfg.bloom_hashes,
                seed=self.cfg.seed + 1,
            )
            self._bloom_fill_warned = False
        elif self._persist_mode:
            from advanced_scrapper_tpu_torch.index import PersistentIndex

            # a re-reset must not leave two live WAL handles on one dir
            if getattr(self, "_pindex", None) is not None:
                self._pindex.close()
                self._pindex_urls.close()
            # two key domains, two sub-indexes; doc ids are allocated from
            # the bands index and posted into both
            self._pindex, self._pindex_urls = (
                PersistentIndex(
                    os.path.join(self._index_dir, sub),
                    cut_postings=self.cfg.index_cut_postings,
                    compact_segments=self.cfg.index_compact_segments,
                )
                for sub in ("bands", "urls")
            )
            # union the durable floors: a crash before the bands index saw
            # an id durably must never reissue one the urls index (or the
            # docmap) already references
            self._pindex.raise_doc_id_floor(self._pindex_urls.doc_id_floor())
        self.stats = BatchStats()
        self._seen_keys: set[str] = set()
        self._buckets: dict[tuple[int, int], int] = {}  # (band, key) -> sig idx
        self._kept_sigs: list[np.ndarray] = []
        self._kept_keys: list[str] = []
        self._kept_coarse: list[np.ndarray] = []  # uint32[nb] coarse keys

    # -- checkpoint/resume -------------------------------------------------

    def _config_fingerprint(self) -> np.ndarray:
        cfg = self.cfg
        return np.array(
            [cfg.num_perm, cfg.num_bands, cfg.shingle_k, cfg.seed,
             cfg.cand_subbands, 1 if self._bloom_mode else 0,
             # num_hashes moves the bit positions without changing a shape
             cfg.bloom_bits, cfg.bloom_hashes],
            dtype=np.int64,
        )

    def save_index(self, path: str, fs=None) -> None:
        """Write the stream index to an npz at ``path``, atomically
        (``storage.fsio.atomic_write``: a crash leaves the previous file).
        Exact mode stores the keys and kept signatures (the buckets are
        rebuilt from them on load); bloom mode the filters' bit-planes."""
        if self._buffer:
            raise ValueError(
                "flush() before save_index(): buffered records would be lost"
            )
        if self._persist_mode:
            # durable as it goes: "save" is the checkpoint's fsync and due cut
            self._pindex.checkpoint()
            self._pindex_urls.checkpoint()
            return
        state: dict = {
            "fingerprint": self._config_fingerprint(),
            "stats": np.array(
                [self.stats.submitted, self.stats.batches, self.stats.exact_dups,
                 self.stats.near_dups, self.stats.kept], dtype=np.int64,
            ),
        }
        if self._bloom_mode:
            for name, idx in (("bloom", self._bloom), ("bloom_urls", self._bloom_urls)):
                for k, v in idx.state().items():
                    state[f"{name}_{k}"] = v
        else:
            state["seen_keys"] = np.array(sorted(self._seen_keys), dtype="U")
            state["kept_keys"] = np.array(self._kept_keys, dtype="U")
            state["kept_sigs"] = (
                np.stack(self._kept_sigs)
                if self._kept_sigs
                else np.zeros((0, self.params.num_perm), np.uint32)
            )
        from advanced_scrapper_tpu_torch.storage.fsio import atomic_write

        def write_npz(fh):
            # np.savez_compressed's own steps, so that a failed write can
            # drop the archive rather than have its __del__ finalise it
            # against the closed tmp handle
            import zipfile

            from numpy.lib import format as npformat

            zf = zipfile.ZipFile(fh, "w", zipfile.ZIP_DEFLATED, allowZip64=True)
            try:
                for name, arr in state.items():
                    with zf.open(name + ".npy", "w", force_zip64=True) as m:
                        npformat.write_array(m, np.asanyarray(arr))
                zf.close()
            except BaseException:
                zf.fp = None
                raise

        atomic_write(path, write_npz, fs=fs)

    def load_index_if_valid(self, path: str, fs=None) -> bool:
        """:meth:`load_index` for a resume: a torn or unreadable checkpoint
        is quarantined to ``<path>.quarantine-<pid>`` and ``False`` returned
        (the stream goes on from an empty index); a config mismatch still
        raises :class:`IndexFingerprintError`."""
        from advanced_scrapper_tpu_torch.storage.fsio import default_fs

        fs = fs or default_fs()
        if self._persist_mode:
            # the persist index recovered itself at construction; ``path`` is
            # an exact-mode npz to import once
            return self._import_legacy_npz(path, fs)
        if not fs.exists(path):
            return False
        try:
            self.load_index(path)
            return True
        except IndexFingerprintError:
            raise
        except Exception as e:
            # load_index fills the state as it reads: drop the half that
            # made it in before the damage was hit
            self._reset_stream_state()
            self._quarantine_ckpt(path, fs, e, "resuming with an empty index")
            return False

    def _quarantine_ckpt(self, path: str, fs, e: Exception, tail: str) -> None:
        """Rename an unreadable checkpoint aside and say so on stderr."""
        quarantine = f"{path}.quarantine-{os.getpid()}"
        try:
            fs.replace(path, quarantine)
        except OSError:
            quarantine = "<unmovable>"
        print(
            f"tpu_batch: stream-index checkpoint {path} is unreadable "
            f"({e}); quarantined to {quarantine}, {tail}",
            file=sys.stderr,
        )

    def close(self) -> None:
        """Close the persist mode's two indexes (nothing to release in the
        exact and bloom modes)."""
        if self._persist_mode:
            self._pindex.close()
            self._pindex_urls.close()

    def load_index(self, path: str) -> None:
        """Inverse of :meth:`save_index`, under the same config (checked by
        the fingerprint)."""
        if self._persist_mode:
            raise ValueError(
                "persist mode has no npz checkpoint to load; the index "
                "recovers itself at construction (use load_index_if_valid "
                "for the legacy-npz auto-import)"
            )
        with np.load(path) as data:
            if not np.array_equal(data["fingerprint"], self._config_fingerprint()):
                raise IndexFingerprintError(
                    f"stream-index checkpoint {path} was written under a "
                    "different dedup config (num_perm/bands/k/seed/subbands/"
                    "stream_index/bloom geometry); refusing to resume against it"
                )
            s = data["stats"]
            self.stats = BatchStats(*(int(x) for x in s))
            if self._bloom_mode:
                for name, idx in (
                    ("bloom", self._bloom), ("bloom_urls", self._bloom_urls)
                ):
                    idx.restore(
                        data[f"{name}_words"],
                        int(data[f"{name}_inserted"]),
                        int(data[f"{name}_key_bits"]),
                    )
                return
            self._seen_keys = set(data["seen_keys"].tolist())
            self._kept_keys = [str(k) for k in data["kept_keys"].tolist()]
            sigs = data["kept_sigs"]
            self._kept_sigs = [sigs[i].copy() for i in range(sigs.shape[0])]
        # the buckets and coarse rows are a function of the kept signatures:
        # the insertion path's candidate keys, first seen wins
        self._buckets = {}
        self._kept_coarse = []
        if sigs.shape[0]:
            sig_t = torch.from_numpy(
                np.ascontiguousarray(sigs, np.uint32).view(np.int32)
            ).to(self.device)
            keys = (
                candidate_keys(sig_t, self.params.band_salt, self.cfg.cand_subbands)
                .cpu().numpy().astype(np.uint32)
            )
            nb = self.params.num_bands
            for i in range(keys.shape[0]):
                self._kept_coarse.append(keys[i, :nb].copy())
                for b in range(keys.shape[1]):
                    self._buckets.setdefault((b, int(keys[i, b])), i)

    def checkpoint(self, path: str | None = None, fs=None) -> None:
        """Persist the stream index (``DedupConfig.ckpt_every_batches`` is
        the caller's cadence): the npz, rewritten atomically; in persist
        mode the WALs' fsync and a due segment cut (``path`` unused)."""
        if self._persist_mode:
            self._pindex.checkpoint()
            self._pindex_urls.checkpoint()
        else:
            self.save_index(path, fs=fs)

    def _import_legacy_npz(self, path: str, fs) -> bool:
        """Import an exact-mode npz into the persist index, once: the kept
        signatures re-derive the wide band keys, the kept urls go to the
        docmap, the seen urls to the urls sub-index; the npz is renamed
        ``<path>.imported``.  A bloom npz holds no per-document state and
        is not imported; an index that already holds postings is left as
        it is; a config mismatch raises :class:`IndexFingerprintError`."""
        if not fs.exists(path):
            return False
        if self._pindex.doc_id_floor() or self._pindex.posting_count():
            return False  # non-empty index: never import twice
        try:
            with np.load(path) as data:
                fp = data["fingerprint"]
                cfg = self.cfg
                expect = [cfg.num_perm, cfg.num_bands, cfg.shingle_k,
                          cfg.seed, cfg.cand_subbands]
                if [int(x) for x in fp[:5]] != expect:
                    raise IndexFingerprintError(
                        f"legacy checkpoint {path} was written under a "
                        "different dedup config (num_perm/bands/k/seed/"
                        "subbands); refusing to import it"
                    )
                if int(fp[5]) != 0:
                    print(
                        f"tpu_batch: legacy checkpoint {path} is a bloom "
                        "stream index (no per-document state); it cannot "
                        "seed the persistent index — starting empty",
                        file=sys.stderr,
                    )
                    return False
                kept_keys = [str(k) for k in data["kept_keys"].tolist()]
                sigs = np.asarray(data["kept_sigs"])
                seen = [str(k) for k in data["seen_keys"].tolist()]
        except IndexFingerprintError:
            raise
        except Exception as e:
            self._quarantine_ckpt(path, fs, e, "persistent index starts empty")
            return False
        n = len(kept_keys)
        kept_pos: dict[str, int] = {}
        if n:
            ids = self._pindex.allocate_doc_ids(n)
            keys64 = pack_keys64(band_keys_wide_host(sigs, self.params.band_salt))
            self._pindex.insert_batch(keys64.ravel(), np.repeat(ids, keys64.shape[1]))
            self._pindex.log_names(ids.tolist(), kept_keys)
            kept_pos = {k: int(i) for k, i in zip(kept_keys, ids)}
        if seen:
            # a seen url that is a kept doc's takes that doc's id, any other
            # a fresh one, named in the docmap too
            url_hash = np.array([hash_key64(k) for k in seen], dtype=np.uint64)
            url_ids = np.empty((len(seen),), np.uint64)
            fresh = [i for i, k in enumerate(seen) if k not in kept_pos]
            for i, k in enumerate(seen):
                if k in kept_pos:
                    url_ids[i] = kept_pos[k]
            if fresh:
                extra = self._pindex.allocate_doc_ids(len(fresh))
                for j, i in enumerate(fresh):
                    url_ids[i] = extra[j]
                self._pindex.log_names(extra.tolist(), [seen[i] for i in fresh])
            self._pindex_urls.insert_batch(url_hash, url_ids)
        self._pindex.checkpoint()
        self._pindex_urls.checkpoint()
        try:
            fs.replace(path, path + ".imported")
        except OSError:
            pass
        print(
            f"tpu_batch: imported legacy stream-index checkpoint {path} "
            f"({n} kept docs, {len(seen)} seen urls) into {self._index_dir}; "
            f"renamed to {path}.imported",
            file=sys.stderr,
        )
        return True

    # -- submission --------------------------------------------------------

    def submit(self, record: dict) -> list[dict]:
        """Queue one record; returns the processed records when a full
        batch was flushed (else an empty list)."""
        self.stats.submitted += 1
        self._buffer.append(record)
        if len(self._buffer) >= self.cfg.batch_size:
            return self._process()
        return []

    def flush(self) -> list[dict]:
        """Process whatever is buffered."""
        return self._process() if self._buffer else []

    # -- internals ---------------------------------------------------------

    def _process(self) -> list[dict]:
        records, self._buffer = self._buffer, []
        self.stats.batches += 1
        clock = self.last_clock = StageClock(self.device)
        # persist mode: one doc id a record, allocated in order; a record
        # that turns out a dup never posts its id
        doc_ids = self._pindex.allocate_doc_ids(len(records)) if self._persist_mode else None

        # exact stage: the seen keys, in bloom mode a 1-band filter over a
        # 64-bit url hash, in persist mode a probe of the urls sub-index
        url_postings = None  # persist mode: deferred (keys, ids, names)
        if not self.exact_stage:
            for rec in records:
                rec["dup_of"] = None
        elif self._persist_mode:
            url_postings = self._url_stage_persist(records, doc_ids)
        elif self._bloom_mode:
            url_hash = np.array(
                [[hash_key64(_key_of(rec, self.key_field))] for rec in records],
                dtype=np.uint64,
            )
            keyed = np.array([bool(_key_of(rec, self.key_field)) for rec in records])
            url_dup = np.zeros(len(records), dtype=bool)
            if keyed.any():
                # across batches by the filter, within the batch by equality
                url_dup[keyed] = self._bloom_urls.check_and_add_batch(url_hash[keyed])
            for i, rec in enumerate(records):
                if url_dup[i]:
                    rec["dup_of"] = BLOOM_SENTINEL
                    self.stats.exact_dups += 1
                else:
                    rec["dup_of"] = None
        else:
            for rec in records:
                key = _key_of(rec, self.key_field)
                if key and key in self._seen_keys:
                    rec["dup_of"] = key
                    self.stats.exact_dups += 1
                else:
                    rec["dup_of"] = None
                    if key:
                        self._seen_keys.add(key)
        clock.lap("exact_stage")

        # near-dup stage: signatures and band keys from one fold and one
        # keys epilogue on the device, joined on the host
        texts = [str(r.get(self.text_field, "") or "") for r in records]
        thresh = self.cfg.sim_threshold
        if self._bloom_mode or self._persist_mode:
            # wide keys: neither index can verify, so key width is the
            # false-drop floor; no signature is read back
            _sigs, keys_wide = self.engine.signatures_and_keys(
                texts, wide=True, sync_sigs=False
            )
            clock.lap("signatures_and_keys")
            keys64 = pack_keys64(keys_wide)
            if self._persist_mode:
                return self._near_dup_persist(records, texts, keys64, doc_ids, url_postings)
            return self._near_dup_bloom(records, texts, keys64)
        sigs, keys = self.engine.signatures_and_keys(texts)
        clock.lap("signatures_and_keys")
        nb = self.params.num_bands
        for i, rec in enumerate(records):
            rec["near_dup_of"] = None
            if rec["dup_of"] is not None:
                continue  # already an exact dup
            if not _key_of(rec, self.key_field):
                continue  # keyless records cannot be dup targets
            if len(texts[i].encode("utf-8", "replace")) < self.params.shingle_k:
                continue  # no shingles: never bucketed
            candidate = None
            for b in range(keys.shape[1]):
                idx = self._buckets.get((b, int(keys[i, b])))
                if idx is None:
                    continue
                # a fine-band hit sharing no coarse band must clear
                # sim_threshold + fine_margin (the batch engine's rule);
                # agreement is a float64 mean against a Python float
                bar = thresh
                if b >= nb and not (keys[i, :nb] == self._kept_coarse[idx]).any():
                    bar = thresh + self.cfg.fine_margin
                agree = float(np.mean(self._kept_sigs[idx] == sigs[i]))
                if agree >= bar:
                    candidate = self._kept_keys[idx]
                    break
            if candidate is not None:
                rec["near_dup_of"] = candidate
                self.stats.near_dups += 1
            else:
                sig_idx = len(self._kept_sigs)
                # copies: a row view would keep the whole batch array alive
                self._kept_sigs.append(sigs[i].copy())
                self._kept_coarse.append(keys[i, :nb].copy())
                self._kept_keys.append(_key_of(rec, self.key_field))
                for b in range(keys.shape[1]):
                    self._buckets.setdefault((b, int(keys[i, b])), sig_idx)
                self.stats.kept += 1
        clock.lap("join")

        if self.sink is not None:
            for rec in records:
                self.sink(rec)
        return records

    def _url_stage_persist(self, records, doc_ids):
        """Persist mode's exact stage: probe the urls sub-index (across
        runs) and equal hashes (within the batch), mark ``dup_of``, and
        return the fresh rows' ``(hashes, ids, urls)`` to post after the
        band postings (``None`` when no record has a url).  A url posted
        without its band postings would, after a crash, make the restarted
        run skip the record as an exact dup and never post its bands."""
        url_hash = np.array(
            [hash_key64(_key_of(rec, self.key_field)) for rec in records], dtype=np.uint64
        )
        keyed = np.array([bool(_key_of(rec, self.key_field)) for rec in records])
        url_attr = np.full(len(records), -1, np.int64)
        url_postings = None
        if keyed.any():
            sub = url_hash[keyed]
            sub_ids = doc_ids[keyed]
            cross = np.asarray(self._pindex_urls.probe_batch(sub))
            _u, first_ix, inverse = np.unique(sub, return_index=True, return_inverse=True)
            earlier = first_ix[inverse]
            # rows sharing a hash share the cross-run verdict; a row repeating
            # a fresh earlier row of the batch names that row's (posted) id
            url_attr[keyed] = np.where(
                cross >= 0,
                cross,
                np.where(earlier < np.arange(sub.size), sub_ids[earlier].astype(np.int64), -1),
            )
            fresh_sub = np.flatnonzero(url_attr[keyed] < 0)
            keyed_ix = np.flatnonzero(keyed)
            url_postings = (
                sub[fresh_sub],
                sub_ids[fresh_sub],
                [_key_of(records[i], self.key_field) for i in keyed_ix[fresh_sub].tolist()],
            )
        for i, rec in enumerate(records):
            if url_attr[i] >= 0:
                rec["dup_of"] = index_ref(url_attr[i])
                self.stats.exact_dups += 1
            else:
                rec["dup_of"] = None
        return url_postings

    def _near_dup_bloom(self, records, texts, keys) -> list[dict]:
        """Bounded-memory near-dup stage: Bloom membership per band.

        Rows that cannot be bucketed (exact dups, keyless, texts without a
        shingle) are neither probed nor inserted.  Within the batch a row
        is a dup of any earlier row sharing a band key, dup or not
        (``BloomBandIndex.check_and_add_batch``)."""
        eligible = np.array(
            [
                rec["dup_of"] is None
                and bool(_key_of(rec, self.key_field))
                and len(texts[i].encode("utf-8", "replace")) >= self.params.shingle_k
                for i, rec in enumerate(records)
            ]
        )
        dup = np.zeros(len(records), dtype=bool)
        if eligible.any():
            dup[eligible] = self._bloom.check_and_add_batch(keys[eligible])
            # O(1) saturation check from the insert count, keyed on the
            # predicted row false-drop rate
            if not self._bloom_fill_warned and self._bloom.predicted_row_fp() > 0.01:
                self._bloom_fill_warned = True
                print(
                    f"tpu_batch: bloom stream index predicted false-drop "
                    f"rate {self._bloom.predicted_row_fp():.2%} after "
                    f"{self._bloom.inserted} docs — rows are being "
                    f"silently dropped as dups; size bloom_bits for the "
                    f"stream (BloomBandIndex.for_capacity)",
                    file=sys.stderr,
                )
        for i, rec in enumerate(records):
            rec["near_dup_of"] = BLOOM_SENTINEL if dup[i] else None
            if dup[i]:
                self.stats.near_dups += 1
            elif eligible[i]:
                self.stats.kept += 1
        self.last_clock.lap("bloom")
        if self.sink is not None:
            for rec in records:
                self.sink(rec)
        return records

    def _near_dup_persist(self, records, texts, keys, doc_ids, url_postings) -> list[dict]:
        """Durable near-dup stage: the bands index decides.

        Eligibility as in the other modes.  Hits name the matched posting's
        doc id (``doc:<id>``); kept rows post their band keys, then the url
        stage's fresh postings land, and every url-fresh row's name goes
        to the docmap, so every ``doc:<id>`` mark resolves."""
        eligible = np.array(
            [
                rec["dup_of"] is None
                and bool(_key_of(rec, self.key_field))
                and len(texts[i].encode("utf-8", "replace")) >= self.params.shingle_k
                for i, rec in enumerate(records)
            ]
        )
        attr = np.full(len(records), -1, np.int64)
        if eligible.any():
            attr[eligible] = self._pindex.check_and_add_batch(keys[eligible], doc_ids[eligible])
        if url_postings is not None:
            u_keys, u_ids, u_names = url_postings
            if u_keys.size:
                self._pindex_urls.insert_batch(u_keys, u_ids)
                self._pindex.log_names(u_ids.tolist(), u_names)
        else:
            # no url stage (exact_stage=False): the kept rows are the only
            # attribution targets, so their keys are the names to log
            kept_rows = np.flatnonzero(eligible & (attr < 0))
            if kept_rows.size:
                self._pindex.log_names(
                    doc_ids[kept_rows].tolist(),
                    [_key_of(records[i], self.key_field) for i in kept_rows.tolist()],
                )
        for i, rec in enumerate(records):
            rec["near_dup_of"] = index_ref(attr[i]) if attr[i] >= 0 else None
            if attr[i] >= 0:
                self.stats.near_dups += 1
            elif eligible[i]:
                self.stats.kept += 1
        self.last_clock.lap("persist")
        if self.sink is not None:
            for rec in records:
                self.sink(rec)
        return records
