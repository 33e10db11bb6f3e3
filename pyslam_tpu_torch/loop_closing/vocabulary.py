"""Bag-of-words vocabularies with device quantisation (port of
``pyslam_tpu/loop_closing/vocabulary.py``).

A vocabulary adopts the session's descriptor layout: 0/1 bit-planes (ORB2,
the 512-bit patterns, AKAZE's 486 bits) get binary codewords (bit-flip
jitter, majority-vote k-means, Hamming quantisation), float descriptors
(SIFT, SURF, KAZE) get float codewords (Gaussian jitter, mean-centroid
k-means, L2 quantisation).  The tree's training code is host numpy, copied
from the reference, so a vocabulary trained from the same descriptors with
the same seed is identical bit for bit.  The flat codebook's k-means and
every quantisation run on the vocabulary's device: the flat codebook as one
distance matrix and argmin, the k-ary tree as ``depth`` rounds of an L1
distance to the current node's children in float32 and an argmin that
keeps the first index.  A float centroid sums its members in row order, as
the reference's scatter-add does, on the CPU and the card alike
(``_ordered_segment_sum``).  Both vocabularies save to and load from the
JAX package's ``.npz`` layout; a tree's ``checksum`` is the JAX package's.
``HierarchicalVocabulary.from_dbow3_text`` imports a pretrained DBoW3 text
vocabulary into the same layout (the reference's parser, copied).
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from pyslam_tpu_torch.ops import hamming


def _device_desc(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        if x.device.type != device.type:
            raise ValueError(f"descriptors on {x.device}, vocabulary on {device}")
        return x
    return torch.as_tensor(np.asarray(x)).to(device)


def _ordered_segment_sum(x: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """(N, D) rows summed into ``num_segments`` rows by ``seg`` (N,), each
    segment's members added one at a time in row order (the sequential
    scatter-add of the reference's CPU backend).  Each round adds the r-th
    member of every segment, so no two adds of a round meet in one row:
    the sums do not depend on the device's scheduling."""
    order = torch.sort(seg, stable=True).indices
    seg_sorted = seg[order]
    counts = torch.bincount(seg, minlength=num_segments)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(seg.shape[0], device=seg.device) - starts[seg_sorted]
    out = torch.zeros((num_segments, x.shape[1]), dtype=x.dtype, device=x.device)
    for r in range(int(counts.max()) if seg.numel() else 0):
        sel = torch.nonzero(rank == r)[:, 0]
        out.index_add_(0, seg_sorted[sel], x[order[sel]])
    return out


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def quantize(desc_bits: torch.Tensor, vocab_bits: torch.Tensor, valid: torch.Tensor):
    """(N, D) descriptors -> (N,) word ids of the nearest codeword (Hamming
    for bits, L2 for floats; first index on ties), -1 where invalid."""
    words = torch.argmin(hamming.descriptor_distance_matrix(desc_bits, vocab_bits), 1)
    return torch.where(valid, words, torch.full_like(words, -1))


def bow_histogram(words: torch.Tensor, weights: torch.Tensor, num_words: int):
    """Weighted, L2-normalised histogram of word ids (-1 ignored)."""
    ok = words >= 0
    h = torch.zeros(num_words, dtype=torch.float32, device=words.device)
    h = h.index_add(0, torch.where(ok, words, 0), ok.to(torch.float32))
    h = h * weights
    n = torch.linalg.norm(h)
    return h / torch.where(n < 1e-9, torch.ones_like(n), n)


class _DocumentStats:
    """idf statistics and the global descriptor, shared by both vocabularies."""

    word_weights = None

    def idf_weights(self) -> np.ndarray:
        if self.word_weights is not None:
            return self.word_weights
        if self.doc_count == 0:
            return np.ones(self.num_words, np.float32)
        return np.log(
            (1.0 + self.doc_count) / (1.0 + self.word_doc_count)
        ).astype(np.float32) + 1e-3

    def add_document(self, words: np.ndarray):
        self.doc_count += 1
        uniq = np.unique(words[words >= 0])
        self.word_doc_count[uniq] += 1

    def global_descriptor(self, words: np.ndarray) -> np.ndarray:
        """L2-normalised tf histogram with uniform weights (a pretrained
        vocabulary's stored weights otherwise): stored and query
        descriptors stay comparable while idf statistics drift."""
        w = (self.word_weights if self.word_weights is not None
             else np.ones(self.num_words, np.float32))
        dev = self.device
        return bow_histogram(torch.as_tensor(np.asarray(words, np.int64)).to(dev),
                             torch.as_tensor(np.asarray(w, np.float32)).to(dev),
                             self.num_words).cpu().numpy()


class BinaryVocabulary(_DocumentStats):
    """Flat codebook, self-seeded from the first descriptors it sees
    (sampled, then bit-flip jittered for bits or Gaussian-jittered for
    floats) and refined by k-means."""

    def __init__(self, num_words: int = 4096, seed: int = 77, *,
                 device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        self.num_words = num_words
        self._rng = np.random.default_rng(seed)
        self.words_bits = self._rng.integers(0, 2, (num_words, 256)).astype(np.int8)
        self._upload()
        self.seeded = False
        self.doc_count = 0
        self.word_doc_count = np.zeros(num_words, np.int64)

    def _upload(self):
        self._words_dev = torch.as_tensor(self.words_bits).to(self.device)

    def seed_from_descriptors(self, desc: np.ndarray, kmeans_iters: int = 2):
        """Initialise the codewords by sampling real descriptors (+ jitter)."""
        desc = np.asarray(desc)
        if len(desc) == 0:
            return
        idx = self._rng.integers(0, len(desc), self.num_words)
        words = desc[idx].copy()
        if np.issubdtype(desc.dtype, np.floating):
            words = words.astype(np.float32)
            sigma = 0.03 * float(np.std(desc)) + 1e-6
            words += self._rng.normal(0, sigma, words.shape).astype(np.float32)
        else:
            dim = desc.shape[1]
            # jitter duplicated samples so words stay distinct: flip ~8 bits
            flips = self._rng.integers(0, dim, (self.num_words, 8))
            for i in range(self.num_words):
                words[i, flips[i]] ^= 1
        self.words_bits = words
        self._upload()
        if kmeans_iters > 0 and len(desc) >= self.num_words // 4:
            self.train_kmeans(desc, iters=kmeans_iters)
        self.seeded = True

    def train_kmeans(self, descriptors: np.ndarray, iters: int = 4):
        """k-means on the device, empty clusters keeping their codeword:
        a majority vote per cluster and bit for bit-planes, the mean for
        float descriptors."""
        is_float = np.issubdtype(np.asarray(descriptors).dtype, np.floating)
        desc = _device_desc(np.asarray(descriptors, np.float32 if is_float else np.int8),
                            self.device)
        vocab = self._words_dev
        descf = desc.to(torch.float32)
        for _ in range(iters):
            assign = torch.argmin(hamming.descriptor_distance_matrix(desc, vocab), 1)
            counts = torch.zeros(self.num_words, dtype=torch.float32,
                                 device=self.device).index_add_(
                0, assign, torch.ones_like(descf[:, 0]))
            if is_float:
                sums = _ordered_segment_sum(descf, assign, self.num_words)
                new = sums / torch.clamp(counts[:, None], min=1.0)
            else:   # sums of 0/1 bits are exact in any order
                sums = torch.zeros((self.num_words, desc.shape[1]), dtype=torch.float32,
                                   device=self.device).index_add_(0, assign, descf)
                new = (sums > counts[:, None] * 0.5).to(torch.int8)
            vocab = torch.where((counts > 0)[:, None], new, vocab)
        self.words_bits = vocab.cpu().numpy()
        self._upload()
        self.seeded = True

    def words_for(self, desc_bits, valid) -> np.ndarray:
        if not self.seeded:
            self.seed_from_descriptors(_host(desc_bits)[_host(valid)])
        valid = torch.as_tensor(_host(valid)).to(self.device)
        return quantize(_device_desc(desc_bits, self.device), self._words_dev,
                        valid).cpu().numpy()

    def save(self, path: str):
        np.savez_compressed(path, words_bits=self.words_bits, doc_count=self.doc_count,
                            word_doc_count=self.word_doc_count)

    @staticmethod
    def load(path: str, *, device: torch.device | str = "cuda") -> "BinaryVocabulary":
        """A seeded codebook on ``device`` from ``save``'s file (either
        package's)."""
        z = np.load(path)
        v = BinaryVocabulary(num_words=z["words_bits"].shape[0], device=device)
        v.words_bits = z["words_bits"]
        v._upload()
        v.seeded = True
        v.doc_count = int(z["doc_count"])
        v.word_doc_count = z["word_doc_count"]
        return v


def quantize_tree(desc: torch.Tensor, valid: torch.Tensor, centroids: torch.Tensor,
                  children: torch.Tensor, node_word: torch.Tensor, depth: int):
    """The k-ary tree descent of all descriptors in lock-step: ``depth``
    rounds of an L1 distance to the current node's children (float32 over
    0/1 bits: exact), first child on ties; a descriptor parked at a leaf
    stays there.  Returns (N,) word ids, -1 where invalid."""
    node = torch.zeros(desc.shape[0], dtype=torch.int64, device=desc.device)
    descf = desc.to(torch.float32)
    inf = torch.full((), float("inf"), device=desc.device)
    for _ in range(depth):
        ch = children[node]                                           # (N, k)
        cent = centroids[torch.clamp(ch, min=0)]                      # (N, k, D)
        d = torch.abs(descf[:, None, :] - cent).sum(-1)
        d = torch.where(ch >= 0, d, inf)
        nxt = torch.gather(ch, 1, torch.argmin(d, 1)[:, None])[:, 0]
        node = torch.where(ch[:, 0] >= 0, nxt, node)
    words = node_word[node]
    return torch.where(valid & (words >= 0), words, torch.full_like(words, -1))


class HierarchicalVocabulary(_DocumentStats):
    """k-branching, depth-L binary vocabulary (the DBoW2/DBoW3 analogue)
    trained by level-wise k-means on the session's descriptors, with the
    direct index: ``level_nodes_for(words, level)`` maps leaf words to
    their ancestor at an intermediate level, which guided matching uses to
    restrict candidate pairs to shared subtrees."""

    def __init__(self, branching: int = 8, depth: int = 4, seed: int = 77, *,
                 device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        self.k = branching
        self.depth = depth
        self.num_words = branching ** depth
        self._rng = np.random.default_rng(seed)
        self.seeded = False
        self.centroids = None     # (num_nodes, D)
        self.children = None      # (num_nodes, k) int32
        self.node_word = None     # (num_nodes,) int32
        self.word_level_node = None  # (num_words, depth) word -> ancestor node
        self.doc_count = 0
        self.word_doc_count = np.zeros(self.num_words, np.int64)
        self._dev = None

    def _finalize(self):
        """Precompute word->ancestor-node tables and device arrays."""
        parent = np.full(len(self.children), -1, np.int64)
        for nid, ch in enumerate(self.children):
            for c in ch:
                if c >= 0:
                    parent[c] = nid
        # ancestor chain per leaf word: level l in [0, depth) = node after
        # l+1 descents from the root (level depth-1 == the leaf itself for
        # complete trees; shallower leaves repeat)
        wl = np.zeros((self.num_words, self.depth), np.int32)
        leaf_of_word = np.full(self.num_words, -1, np.int64)
        for nid, w in enumerate(self.node_word):
            if w >= 0:
                leaf_of_word[w] = nid
        for w, leaf in enumerate(leaf_of_word):
            if leaf < 0:
                continue
            chain = []
            n = leaf
            while n > 0:
                chain.append(n)
                n = parent[n]
            chain = chain[::-1]  # root-child ... leaf
            for l in range(self.depth):
                wl[w, l] = chain[min(l, len(chain) - 1)]
        self.word_level_node = wl
        dev = self.device
        self._dev = (torch.as_tensor(self.centroids.astype(np.float32)).to(dev),
                     torch.as_tensor(self.children.astype(np.int64)).to(dev),
                     torch.as_tensor(self.node_word.astype(np.int64)).to(dev))
        self.seeded = True

    def seed_from_descriptors(self, desc: np.ndarray, iters: int = 3):
        """Level-wise hierarchical k-means over real session descriptors
        (binary: majority-vote centroids; float: means)."""
        desc = np.asarray(desc)
        if len(desc) == 0:
            return
        is_float = np.issubdtype(desc.dtype, np.floating)
        dtype = np.float32 if is_float else np.int8
        D = desc.shape[1]
        k = self.k

        def kmeans(sample, k_eff):
            if len(sample) <= k_eff:
                cents = sample.copy()
                # pad with jittered copies
                while len(cents) < k_eff:
                    j = sample[self._rng.integers(0, len(sample))].copy()
                    if is_float:
                        j = j + self._rng.normal(0, 1e-3, j.shape)
                    else:
                        flip = self._rng.integers(0, D, 8)
                        j[flip] ^= 1
                    cents = np.concatenate([cents, j[None]], axis=0)
                return cents.astype(dtype)
            cents = sample[
                self._rng.choice(len(sample), k_eff, replace=False)
            ].astype(np.float32)
            for _ in range(iters):
                d = np.abs(
                    sample.astype(np.float32)[:, None, :] - cents[None]
                ).sum(-1)
                a = d.argmin(1)
                for j in range(k_eff):
                    sel = sample[a == j]
                    if len(sel):
                        m = sel.astype(np.float32).mean(0)
                        cents[j] = m if is_float else (m > 0.5)
            return cents.astype(dtype)

        # build the complete tree breadth-first: node 0 = root
        centroids = [np.zeros((D,), dtype)]
        children: list[list[int]] = [[]]
        node_word: list[int] = [-1]
        assign = {0: desc}
        word_count = 0
        frontier = [0]
        for level in range(self.depth):
            nxt = []
            for nid in frontier:
                sample = assign.pop(nid, None)
                if sample is None or len(sample) == 0:
                    sample = desc[self._rng.integers(0, len(desc), 4)]
                cents = kmeans(sample, k)
                d = np.abs(
                    sample.astype(np.float32)[:, None, :]
                    - cents.astype(np.float32)[None]
                ).sum(-1)
                a = d.argmin(1)
                for j in range(k):
                    cid = len(centroids)
                    centroids.append(cents[j])
                    children.append([])
                    if level == self.depth - 1:
                        node_word.append(word_count)
                        word_count += 1
                    else:
                        node_word.append(-1)
                        assign[cid] = sample[a == j]
                    children[nid].append(cid)
                    nxt.append(cid)
            frontier = nxt
        self.num_words = word_count
        self.word_doc_count = np.zeros(self.num_words, np.int64)
        self.centroids = np.stack(centroids).astype(dtype)
        self.children = np.array(
            [ch + [-1] * (k - len(ch)) for ch in children], np.int32
        )
        self.node_word = np.asarray(node_word, np.int32)
        self._finalize()

    @staticmethod
    def from_dbow3_text(path: str, *, device: torch.device | str = "cuda"
                        ) -> "HierarchicalVocabulary":
        """A tree on ``device`` from the DBoW3 text vocabulary format
        (``Vocabulary.cpp load_fromtxt``): a header ``k L scoring
        weighting``, then one node a line, ``parent_id is_leaf byte_0 ..
        byte_{B-1} weight``, in creation order (node ids implicit, the root
        0 exists, leaf word ids in order of appearance).  The bytes unpack
        to 0/1 bit-planes; the leaves' weights become the fixed idf."""
        with open(path) as f:
            header = f.readline().split()
            k, L = int(header[0]), int(header[1])
            v = HierarchicalVocabulary(branching=k, depth=L, device=device)
            centroids = [None]
            children: list[list[int]] = [[]]
            node_word = [-1]
            weights = []
            for line in f:
                parts = line.split()
                if len(parts) < 3:
                    continue
                pid, is_leaf = int(parts[0]), int(float(parts[1]))
                byts = np.asarray([float(x) for x in parts[2:-1]], np.uint8)
                w = float(parts[-1])
                nid = len(centroids)
                centroids.append(np.unpackbits(byts).astype(np.int8))
                children.append([])
                children[pid].append(nid)
                if is_leaf:
                    node_word.append(len(weights))
                    weights.append(w)
                else:
                    node_word.append(-1)
        D = len(centroids[1])
        centroids[0] = np.zeros((D,), np.int8)
        v.num_words = len(weights)
        v.word_doc_count = np.zeros(v.num_words, np.int64)
        v.word_weights = np.asarray(weights, np.float32)
        v.centroids = np.stack(centroids)
        width = max(k, max((len(c) for c in children), default=1))
        v.children = np.array([ch + [-1] * (width - len(ch)) for ch in children], np.int32)
        v.node_word = np.asarray(node_word, np.int32)
        v._finalize()
        return v

    def words_for(self, desc, valid) -> np.ndarray:
        if not self.seeded:
            self.seed_from_descriptors(_host(desc)[_host(valid)])
        c, ch, nw = self._dev
        valid = torch.as_tensor(_host(valid)).to(self.device)
        return quantize_tree(_device_desc(desc, self.device), valid, c, ch, nw,
                             self.depth).cpu().numpy()

    def level_nodes_for(self, words: np.ndarray, level: int) -> np.ndarray:
        """Direct index: ancestor node ids at ``level`` (0 = coarsest) of leaf
        word ids; -1 stays -1."""
        out = np.full(len(words), -1, np.int64)
        ok = words >= 0
        out[ok] = self.word_level_node[words[ok], level]
        return out

    def checksum(self) -> str:
        """First 16 hex digits of the SHA-1 of the centroids' and the
        children's bytes (the JAX package's, for the same tree)."""
        h = hashlib.sha1()
        h.update(np.ascontiguousarray(self.centroids).tobytes())
        h.update(np.ascontiguousarray(self.children).tobytes())
        return h.hexdigest()[:16]

    def save(self, path: str):
        np.savez_compressed(
            path, hier_k=self.k, hier_depth=self.depth, centroids=self.centroids,
            children=self.children, node_word=self.node_word,
            word_weights=(self.word_weights if self.word_weights is not None
                          else np.zeros(0, np.float32)),
            doc_count=self.doc_count, word_doc_count=self.word_doc_count)

    @staticmethod
    def load(path: str, *, device: torch.device | str = "cuda") -> "HierarchicalVocabulary":
        """A trained tree on ``device`` from ``save``'s file (either
        package's)."""
        z = np.load(path)
        v = HierarchicalVocabulary(branching=int(z["hier_k"]), depth=int(z["hier_depth"]),
                                   device=device)
        v.centroids = z["centroids"]
        v.children = z["children"]
        v.node_word = z["node_word"]
        v.num_words = int((v.node_word >= 0).sum())
        ww = z["word_weights"]
        v.word_weights = ww if len(ww) else None
        v.doc_count = int(z["doc_count"])
        v.word_doc_count = z["word_doc_count"]
        v._finalize()
        return v
