"""Full-text index with TF-IDF ranking.

Parity reference: shard/index/text/text.go — bleve "standard" analyser
(unicode word tokenization, lowercasing, English stop-word removal), term →
doc-id postings plus per-doc term-frequency maps, TF-IDF scoring
``tf * log10(N / (df + 1))`` with tf = freq/doc_length (text.go:353-372),
containsAll → intersection / containsAny → union, filter intersection, sort
by score descending and truncate both results and result set to the limit
(text.go:305-396).
"""

from __future__ import annotations

import math
import re
import struct
from typing import Dict, Optional, Set, Tuple

import msgpack
import numpy as np

from semadb_tpu_torch.models import constants as C
from semadb_tpu_torch.models.point import SearchResult
from semadb_tpu_torch.models.query import TextOptions
from semadb_tpu_torch.store.diskstore import Bucket
from semadb_tpu_torch.utils.itemcache import Codec, ItemCache

# Lucene/bleve classic English stop set (the "standard" analyser's filter)
STOP_WORDS = frozenset(
    "a an and are as at be but by for if in into is it no not of on or such "
    "that the their then there these they this to was will with".split()
)

# UAX #29 word segmentation, the way bleve's "standard" tokenizer does it
# (text.go:69-96 → blevesearch/segment). The practically load-bearing
# rules, as a regex over explicit script classes:
#   - katakana runs stay one token (Katakana × Katakana)
#   - Han/Hiragana ideographs tokenize ONE PER CHARACTER (they carry no
#     ALetter property, so every boundary breaks)
#   - apostrophes (' ’) and periods are MidNumLet: they JOIN when medial
#     between alphanumerics ("don't", "john's", "example.com" are single
#     tokens; trailing/leading ones split)
#   - comma is MidNum: joins digits only ("1,000" one token, "a,b" two)
#   - everything else (hyphens, whitespace, punctuation) breaks
_CJK = "一-鿿㐀-䶿豈-﫿぀-ゟ゠-ヿㇰ-ㇿ"
_ALNUM = rf"[^\W_{_CJK}]"  # unicode letters+digits minus CJK scripts
_TOKEN_RE = re.compile(
    rf"[゠-ヿㇰ-ㇿ]+"  # katakana run
    rf"|[一-鿿㐀-䶿豈-﫿぀-ゟ]"  # han/hiragana, 1/char
    rf"|{_ALNUM}+(?:['’.]{_ALNUM}+|(?<=\d),(?=\d)\d+)*",
    re.UNICODE,
)

NUM_DOCS_KEY = b"_numDocs"
_SET_PREFIX = b"t"  # t<term>s → postings (text.go key layout)
_DOC_PREFIX = b"d"  # d<8B docId> → {term: freq} + length


def analyse(value: str) -> list[str]:
    """Standard analyser: unicode word tokens, lowercased, stop words removed."""
    return [t for t in (m.group(0).lower() for m in _TOKEN_RE.finditer(value)) if t not in STOP_WORDS]


def _set_key(term: str) -> bytes:
    return _SET_PREFIX + term.encode("utf-8") + b"s"


def _doc_key(doc_id: int) -> bytes:
    return _DOC_PREFIX + struct.pack("<Q", doc_id)


class Postings:
    """One term's posting list as parallel sorted numpy arrays: doc ids
    (i64, ascending) and the doc's normalized term frequency tf =
    freq/doc_length (f32). Storing tf IN the postings makes TF-IDF
    scoring pure array math over the posting lists — the reference
    fetches every candidate's doc map instead (text.go:353-372), which
    measured 1.3 QPS at 100k docs for common-term containsAny here
    (~80k bucket gets + msgpack decodes per query). Mutations buffer in
    a dict and compact on read/encode, so batch writes stay O(changes).
    """

    __slots__ = ("ids", "tf", "_pending")

    def __init__(self, ids=None, tf=None):
        import numpy as np

        self.ids = ids if ids is not None else np.empty(0, np.int64)
        self.tf = tf if tf is not None else np.empty(0, np.float32)
        self._pending: Dict[int, Optional[float]] = {}  # None = deleted

    def set(self, doc_id: int, tf: float) -> None:
        self._pending[doc_id] = tf

    def discard(self, doc_id: int) -> None:
        self._pending[doc_id] = None

    def _compact(self) -> None:
        if not self._pending:
            return
        import numpy as np

        pend = self._pending
        self._pending = {}
        upd_ids = np.fromiter(pend.keys(), np.int64, len(pend))
        # Drop pending ids from the base, then append the survivors
        keep = ~np.isin(self.ids, upd_ids, assume_unique=True)
        live = [(i, v) for i, v in pend.items() if v is not None]
        add_ids = np.array([i for i, _ in live], np.int64)
        add_tf = np.array([v for _, v in live], np.float32)
        ids = np.concatenate([self.ids[keep], add_ids])
        tf = np.concatenate([self.tf[keep], add_tf])
        order = np.argsort(ids, kind="stable")
        self.ids, self.tf = ids[order], tf[order]

    def arrays(self):
        self._compact()
        return self.ids, self.tf

    def __len__(self) -> int:
        self._compact()
        return len(self.ids)

    def __contains__(self, doc_id: int) -> bool:
        self._compact()
        import numpy as np

        pos = np.searchsorted(self.ids, doc_id)
        return bool(pos < len(self.ids) and self.ids[pos] == doc_id)


def _encode_postings(p: Optional[Postings]):
    if p is None:
        return None
    ids, tf = p.arrays()
    if len(ids) == 0:
        return None  # delete-on-empty (text.go setCacheItem)
    return msgpack.packb((ids.tobytes(), tf.tobytes()))


def _decode_postings(raw: bytes) -> Postings:
    import numpy as np

    obj = msgpack.unpackb(raw, raw=False)
    if obj and isinstance(obj[0], int):
        # Legacy layout (id list only, rounds ≤4 snapshots): tf comes
        # from the doc maps on first touch — search's slow-path fallback.
        ids = np.asarray(obj, np.int64)
        return Postings(ids, np.full(len(ids), np.nan, np.float32))
    ids_b, tf_b = obj
    return Postings(
        np.frombuffer(ids_b, np.int64).copy(),
        np.frombuffer(tf_b, np.float32).copy(),
    )


def _postings_codec() -> "Codec[str, Postings]":
    """t<term>s → (ids i64[], tf f32[]) packed arrays; empty postings
    delete the key (text.go setCacheItem delete-on-empty)."""
    return Codec(
        key_bytes=_set_key,
        key_from=lambda kb: (
            kb[len(_SET_PREFIX) : -1].decode("utf-8")
            if kb.startswith(_SET_PREFIX) and kb.endswith(b"s")
            else None
        ),
        encode=_encode_postings,
        decode=_decode_postings,
    )


def _doc_codec() -> "Codec[int, Tuple[Dict[str, int], int]]":
    """d<8B docId> → ({term: freq}, length) (text.go docCacheItem)."""
    return Codec(
        key_bytes=_doc_key,
        key_from=lambda kb: (
            struct.unpack("<Q", kb[1:])[0]
            if kb.startswith(_DOC_PREFIX) and len(kb) == 9
            else None
        ),
        encode=lambda dv: msgpack.packb({"terms": dv[0], "length": dv[1]}),
        decode=lambda raw: (
            (lambda o: (o["terms"], o["length"]))(msgpack.unpackb(raw, raw=False))
        ),
    )


class TextCaches:
    """Cross-txn cache bundle for one text bucket (held in the Shard's
    host_caches): the two ItemCaches plus the doc count."""

    __slots__ = ("postings", "docs", "ndocs")

    def __init__(self, postings, docs, ndocs=None):
        self.postings = postings
        self.docs = docs
        self.ndocs = ndocs

    def rebind(self, bucket) -> None:
        self.postings.rebind(bucket)
        self.docs.rebind(bucket)

    def scrap(self) -> None:
        self.postings.scrap()
        self.docs.scrap()
        self.ndocs = None


class IndexText:
    """Write-back cached text index (text.go:400-535 setCacheItem/
    docCacheItem parity): postings AND per-doc term maps each sit behind a
    generic :class:`~semadb_tpu.utils.itemcache.ItemCache` — decode once
    per batch, mutate in memory, persist once on ``flush``."""

    def __init__(self, bucket: Bucket, analyser: str = "standard", cache=None):
        if analyser != "standard":
            raise ValueError(f"unknown analyser {analyser}")
        self.bucket = bucket
        if cache is not None:
            # Cross-txn caches owned by the Shard (cache/manager.go:116-303
            # shared-cache parity): decoded postings + doc maps survive
            # across transactions; only the bucket binding is per-txn.
            self._state = cache
            cache.postings.rebind(bucket)
            cache.docs.rebind(bucket)
        else:
            self._state = TextCaches(
                postings=ItemCache(bucket, _postings_codec()),
                docs=ItemCache(bucket, _doc_codec()),
            )
        self._postings = self._state.postings
        self._docs = self._state.docs

    # -- helpers -----------------------------------------------------------
    @property
    def _ndocs(self) -> Optional[int]:
        return self._state.ndocs

    @_ndocs.setter
    def _ndocs(self, v) -> None:
        self._state.ndocs = v

    @property
    def num_docs(self) -> int:
        if self._ndocs is None:
            raw = self.bucket.get(NUM_DOCS_KEY)
            self._ndocs = struct.unpack("<Q", raw)[0] if raw else 0
        return self._ndocs

    def _set_num_docs(self, n: int) -> None:
        self._ndocs = max(n, 0)

    def _get_postings(self, term: str) -> Postings:
        return self._postings.get(term) or Postings()

    def _get_doc(self, doc_id: int) -> Optional[Tuple[Dict[str, int], int]]:
        return self._docs.get(doc_id)

    def flush(self) -> None:
        """Persist dirty postings/docs + doc count (ItemCache.Flush)."""
        self._postings.flush()
        self._docs.flush()
        if self._ndocs is not None:
            self.bucket.put(NUM_DOCS_KEY, struct.pack("<Q", self._ndocs))

    # -- writes ------------------------------------------------------------
    def insert(self, doc_id: int, value: str) -> None:
        tokens = analyse(value)
        freqs: Dict[str, int] = {}
        for t in tokens:
            freqs[t] = freqs.get(t, 0) + 1
        length = max(len(tokens), 1)
        self._docs.put(doc_id, (freqs, length))
        for term, freq in freqs.items():
            self._postings.get_or_create(term, Postings).set(
                doc_id, freq / length
            )
        self._set_num_docs(self.num_docs + 1)

    def delete(self, doc_id: int) -> None:
        doc = self._get_doc(doc_id)
        if doc is None:
            return
        freqs, _ = doc
        for term in freqs:
            self._postings.get_or_create(term, Postings).discard(doc_id)
        self._docs.delete(doc_id)
        self._set_num_docs(self.num_docs - 1)

    def update(self, doc_id: int, value: str) -> None:
        self.delete(doc_id)
        self.insert(doc_id, value)

    # -- search ------------------------------------------------------------
    def _tf_arrays(self, term: str):
        """(ids i64[], tf f32[]) for one term, resolving legacy (tf-less)
        posting entries through the doc maps once and upgrading the cached
        value in place."""
        p = self._get_postings(term)
        ids, tf = p.arrays()
        if len(ids) and np.isnan(tf).any():
            tf = tf.copy()
            for j in np.nonzero(np.isnan(tf))[0]:
                doc = self._get_doc(int(ids[j]))
                if doc is None:
                    tf[j] = 0.0
                else:
                    freqs, length = doc
                    tf[j] = freqs.get(term, 0) / length
            p.tf = tf
        return ids, tf

    def search(
        self, options: TextOptions, filter_set: Optional[Set[int]] = None
    ) -> Tuple[Set[int], list[SearchResult]]:
        """TF-IDF scoring as pure array math over the posting lists
        (score = Σ_t tf[t,doc]·idf[t]): one concatenate + segment-sum over
        the candidate union instead of a doc-map fetch per candidate —
        the per-doc loop (text.go:353-372 parity shape) measured 1.3 QPS
        on common-term containsAny at 100k docs; this path measures 3
        orders of magnitude faster at identical scores."""
        query_terms = sorted(set(analyse(options.value)))
        n_docs = self.num_docs
        if not query_terms or not n_docs:
            return set(), []
        per_term = [self._tf_arrays(t) for t in query_terms]
        idf = [
            math.log10(n_docs / (len(ids) + 1)) if n_docs else 0.0
            for ids, _ in per_term
        ]
        if options.operator == C.OPERATOR_CONTAINS_ALL:
            # Intersect the (sorted, unique) posting ids FIRST — the
            # candidate set shrinks to the rarest term's scale before any
            # scoring work — then gather each term's tf by searchsorted.
            uniq = per_term[0][0]
            for ids, _ in per_term[1:]:
                uniq = np.intersect1d(uniq, ids, assume_unique=True)
                if len(uniq) == 0:
                    return set(), []
            scores = np.zeros(len(uniq), np.float64)
            for (ids, tf), w in zip(per_term, idf):
                pos = np.searchsorted(ids, uniq)
                scores += tf[pos] * w
        else:
            all_ids = np.concatenate([ids for ids, _ in per_term])
            if len(all_ids) == 0:
                return set(), []
            all_w = np.concatenate(
                [tf * w for (_, tf), w in zip(per_term, idf)]
            ).astype(np.float64)
            # Segment-sum scores over the candidate union
            uniq, inv = np.unique(all_ids, return_inverse=True)
            scores = np.zeros(len(uniq), np.float64)
            np.add.at(scores, inv, all_w)
        if filter_set is not None:
            fmask = np.isin(uniq, np.fromiter(filter_set, np.int64, len(filter_set)))
            uniq, scores = uniq[fmask], scores[fmask]
        limit = options.limit
        if len(uniq) > limit:
            top = np.argpartition(-scores, limit - 1)[:limit]
            uniq, scores = uniq[top], scores[top]
        order = np.argsort(-scores, kind="stable")
        uniq, scores = uniq[order], scores[order]
        weight = options.weight if options.weight is not None else 1.0
        id_list = uniq.tolist()
        score_list = scores.tolist()
        results = [
            SearchResult(
                point=None, node_id=i, score=s, hybrid_score=s * weight
            )
            for i, s in zip(id_list, score_list)
        ]
        return set(id_list), results
