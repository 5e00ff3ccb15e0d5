"""The prompt tokenizers of the port: CLIP's byte-level BPE and the
`tokenizer.json` Unigram tokenizers of T5 and UMT5, in plain Python.

The JAX package tokenizes with transformers (`CLIPTokenizer`,
`T5TokenizerFast`, `AutoTokenizer`; fastdm_tpu/pipeline/text_encoder.py:41-53,
160, 211), whose fast tokenizers run the Rust `tokenizers` crate. The port
reads the same files and gives the same ids with neither package, nor
`sentencepiece`, `regex` or `ftfy`:

  * CLIPTokenizer -- vocab.json + merges.txt, as transformers' slow
    CLIPTokenizer without ftfy: its BasicTokenizer branch (control
    characters dropped, CJK characters spaced, NFC, lower case, no
    punctuation split), the `\\p{L}` / `\\p{N}` split pattern classified
    with unicodedata, byte-level BPE, then <|startoftext|> ... <|endoftext|>
    truncated and padded to max_length. The special tokens are split off
    first, as the slow tokenizer's trie does (the bigG tokenizers' pad
    token "!" too).
  * UnigramTokenizer -- a tokenizer.json with the normalizers Sequence,
    Precompiled (the sentencepiece charsmap: a darts-clone double array
    and the normalized strings, read as the crate's spm_precompiled does,
    grapheme by grapheme), Replace, NFKC and Strip; the Metaspace
    pre-tokenizer (prepend_scheme always / first / never, split); the Unigram
    model (Viterbi over the pieces, an unknown character scored at the
    lowest score - 10, consecutive unknowns fused); added tokens matched
    before normalization (or after it, for the normalized ones);
    TemplateProcessing; right padding; truncation that keeps room for the
    template's tokens.

load_tokenizer(dir) picks one by the files in the directory. Both return
(ids, attention_mask) as int64 numpy arrays of (len(prompts), max_length).
"""

from __future__ import annotations

import base64
import json
import os
import re
import struct
import unicodedata
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# Unicode White_Space (Rust's char::is_whitespace; Python's str.isspace also
# takes U+001C..U+001F)
_WHITE_SPACE = frozenset(
    [chr(c) for c in (*range(0x09, 0x0E), 0x20, 0x85, 0xA0, 0x1680, *range(0x2000, 0x200B),
                      0x2028, 0x2029, 0x202F, 0x205F, 0x3000)])


def _as_list(prompt) -> List[str]:
    return [prompt] if isinstance(prompt, str) else list(prompt)


def _read_json(path: str):
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def _content(tok) -> Optional[str]:
    """A special token's text: a string or an AddedToken's dict."""
    return tok.get("content") if isinstance(tok, dict) else tok


def _special_tokens(path: str) -> Dict[str, str]:
    """bos / eos / unk / pad of a tokenizer directory: special_tokens_map.json
    over tokenizer_config.json, as transformers reads them."""
    out: Dict[str, str] = {}
    for name in ("tokenizer_config.json", "special_tokens_map.json"):
        p = os.path.join(path, name)
        if os.path.exists(p):
            cfg = _read_json(p)
            for key in ("bos_token", "eos_token", "unk_token", "pad_token"):
                if cfg.get(key) is not None:
                    out[key] = _content(cfg[key])
    return out


# ------------------------------------------------------------------ CLIP


@lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable character table."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + \
        list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
            or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F
            or 0x2B820 <= cp <= 0x2CEAF or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def clip_basic_clean(text: str) -> str:
    """transformers' BasicTokenizer(strip_accents=False, do_split_on_punc=False),
    the CLIP tokenizer's branch without ftfy: NUL, U+FFFD and control
    characters dropped, \\t \\n \\r and Zs to a space, CJK characters spaced,
    NFC, split on whitespace, each word lower-cased, joined by one space."""
    out = []
    for ch in text:
        cp = ord(ch)
        if ch in " \t\n\r" or unicodedata.category(ch) == "Zs":
            out.append(" ")
        elif cp == 0 or cp == 0xFFFD or unicodedata.category(ch).startswith("C"):
            continue
        elif _is_cjk(cp):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    words = unicodedata.normalize("NFC", "".join(out)).split()
    return " ".join(" ".join(w.lower() for w in words).split())


_CLIP_SPECIAL = ("<|startoftext|>", "<|endoftext|>")
_CLIP_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _char_class(ch: str) -> str:
    """'L' (a \\p{L} letter), 'N' (a \\p{N} number), 'O' (neither, nor white
    space) or 'S' (matched by no class: white space, and U+0345, which the
    regex module's IGNORECASE keeps out of both [\\p{L}] and its negation,
    its case fold being a letter)."""
    cat = unicodedata.category(ch)
    if cat[0] in "LN":
        return cat[0]
    return "S" if ch in _WHITE_SPACE or ch == "\u0345" else "O"


def _ci_startswith(text: str, lit: str, i: int) -> bool:
    """text[i:] starts with the lower-case ASCII literal under IGNORECASE
    (U+017F, the long s, folds to s)."""
    if i + len(lit) > len(text):
        return False
    return all(c == l or c.lower() == l or (l == "s" and c == "\u017f")
               for c, l in zip(text[i:i + len(lit)], lit))


def clip_split(text: str) -> List[str]:
    """re.findall of CLIP's pattern
    <\\|startoftext\\|>|<\\|endoftext\\|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+
    (IGNORECASE), its alternatives tried in order at each position."""
    out, i, n = [], 0, len(text)
    while i < n:
        for lit in _CLIP_SPECIAL + _CLIP_CONTRACTIONS:
            if _ci_startswith(text, lit, i):
                out.append(text[i:i + len(lit)])
                i += len(lit)
                break
        else:
            cls = _char_class(text[i])
            if cls == "S":
                i += 1
                continue
            j = i + 1
            if cls == "L":
                while j < n and _char_class(text[j]) == "L":
                    j += 1
            elif cls == "O":
                while j < n and _char_class(text[j]) == "O":
                    j += 1
            out.append(text[i:j])
            i = j
    return out


class CLIPTokenizer:
    """Byte-level BPE over vocab.json and merges.txt (transformers' slow
    CLIPTokenizer, no ftfy)."""

    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]],
                 bos: str = "<|startoftext|>", eos: str = "<|endoftext|>",
                 pad: str = "<|endoftext|>", unk: str = "<|endoftext|>",
                 added: Optional[Dict[str, int]] = None):
        self.encoder = dict(vocab)
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.cache = {t: t for t in _CLIP_SPECIAL}
        # the special tokens the slow tokenizer adds to its trie, with their ids
        self.added = dict(added or {})
        for tok in (bos, eos, pad, unk):
            if tok not in self.added:
                self.added[tok] = self.encoder[tok] if tok in self.encoder \
                    else len(self.encoder) + len(self.added)
        self._added_re = re.compile("|".join(
            re.escape(t) for t in sorted(self.added, key=len, reverse=True)))
        self.bos_id, self.eos_id = self.added[bos], self.added[eos]
        self.pad_id, self.unk_id = self.added[pad], self.added[unk]

    @classmethod
    def from_dir(cls, path: str) -> "CLIPTokenizer":
        vocab = _read_json(os.path.join(path, "vocab.json"))
        with open(os.path.join(path, "merges.txt"), "r", encoding="utf-8") as f:
            # the slow tokenizer's slice: the first line is taken for the
            # "#version" header, and at most 49152 - 256 - 2 merges are read
            lines = f.read().strip().split("\n")[1:49152 - 256 - 2 + 1]
        merges = [tuple(line.split()) for line in lines]
        special = {"bos": "<|startoftext|>", "eos": "<|endoftext|>",
                   "pad": "<|endoftext|>", "unk": "<|endoftext|>"}
        special.update({k[:-6]: v for k, v in _special_tokens(path).items()})
        added: Dict[str, int] = {}
        cfg = os.path.join(path, "tokenizer_config.json")
        if os.path.exists(cfg):
            for idx, tok in (_read_json(cfg).get("added_tokens_decoder") or {}).items():
                added[tok["content"]] = int(idx)
        return cls(vocab, merges, added=added, **special)

    def bpe(self, token: str) -> List[str]:
        if token in self.cache:
            return self.cache[token].split(" ")
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new, i = [], 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new.extend(word[i:])
                    break
                new.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new.append(first + second)
                    i += 2
                else:
                    new.append(word[i])
                    i += 1
            word = tuple(new)
        self.cache[token] = " ".join(word)
        return list(word)

    def _token_id(self, tok: str) -> int:
        if tok in self.added:
            return self.added[tok]
        return self.encoder.get(tok, self.unk_id)

    def encode(self, text: str) -> List[int]:
        """The ids of one prompt, without <|startoftext|> / <|endoftext|>."""
        ids: List[int] = []
        pos = 0
        for m in list(self._added_re.finditer(text)) + [None]:
            piece = text[pos:m.start()] if m is not None else text[pos:]
            for word in clip_split(clip_basic_clean(piece)) if piece else ():
                word = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
                ids.extend(self._token_id(t) for t in self.bpe(word))
            if m is not None:
                ids.append(self.added[m.group()])
                pos = m.end()
        return ids

    def __call__(self, prompt, max_length: int = 77) -> Tuple[np.ndarray, np.ndarray]:
        rows = [[self.bos_id] + self.encode(p)[:max_length - 2] + [self.eos_id]
                for p in _as_list(prompt)]
        return _pad(rows, max_length, self.pad_id)


def _pad(rows: List[List[int]], max_length: int, pad_id: int) -> Tuple[np.ndarray, np.ndarray]:
    ids = np.full((len(rows), max_length), pad_id, np.int64)
    mask = np.zeros((len(rows), max_length), np.int64)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = r
        mask[i, :len(r)] = 1
    return ids, mask


# ------------------------------------------------------ the Precompiled charsmap


_HANGUL_L = ((0x1100, 0x115F), (0xA960, 0xA97C))
_HANGUL_V = ((0x1160, 0x11A7), (0xD7B0, 0xD7C6))
_HANGUL_T = ((0x11A8, 0x11FF), (0xD7CB, 0xD7FB))
# Grapheme_Cluster_Break=Prepend
_PREPEND = frozenset([*range(0x600, 0x606), 0x6DD, 0x70F, 0x890, 0x891, 0x8E2, 0xD4E, 0x110BD,
                      0x110CD, 0x111C2, 0x111C3, 0x1193F, 0x11941, 0x11A3A,
                      *range(0x11A84, 0x11A8A), 0x11D46, 0x11F02])
# Other_Grapheme_Extend outside Mn / Me (spacing marks that extend), ZWNJ,
# the halfwidth sound marks and the emoji modifiers
_EXTEND_EXTRA = frozenset([0x9BE, 0x9D7, 0xB3E, 0xB57, 0xBBE, 0xBD7, 0xCC2, 0xCD5, 0xCD6,
                           0xD3E, 0xD57, 0xDCF, 0xDDF, 0x1B35, 0x200C, 0x302E, 0x302F,
                           0xFF9E, 0xFF9F, 0x1D165, *range(0x1D16E, 0x1D173),
                           *range(0x1F3FB, 0x1F400)])


def _in(cp: int, ranges) -> bool:
    return any(a <= cp <= b for a, b in ranges)


def _gcb(ch: str) -> str:
    """The Grapheme_Cluster_Break class that decides the rules below."""
    cp = ord(ch)
    if ch == "\r":
        return "CR"
    if ch == "\n":
        return "LF"
    if cp == 0x200D:
        return "ZWJ"
    if 0x1F1E6 <= cp <= 0x1F1FF:
        return "RI"
    if cp in _PREPEND:
        return "Prepend"
    cat = unicodedata.category(ch)
    if cat in ("Mn", "Me") or cp in _EXTEND_EXTRA or 0xE0020 <= cp <= 0xE007F:
        return "Extend"
    if cat in ("Cc", "Zl", "Zp", "Cf", "Cs"):
        return "Control"
    if cat == "Mc" or cp in (0xE33, 0xEB3):
        return "SpacingMark"
    if _in(cp, _HANGUL_L):
        return "L"
    if _in(cp, _HANGUL_V):
        return "V"
    if _in(cp, _HANGUL_T):
        return "T"
    if 0xAC00 <= cp <= 0xD7A3:
        return "LV" if (cp - 0xAC00) % 28 == 0 else "LVT"
    return "Other"


def graphemes(text: str) -> List[str]:
    """Extended grapheme clusters (UAX #29 rules GB3-GB9b, GB12-13). The
    Indic-conjunct (GB9c) and emoji-ZWJ (GB11) joins are left out: they only
    join clusters of 6 or more UTF-8 bytes, which the charsmap reads one
    character at a time anyway."""
    out: List[str] = []
    prev, ri = None, 0
    for ch in text:
        cls = _gcb(ch)
        join = prev is not None and not (
            prev in ("Control", "CR", "LF") and not (prev == "CR" and cls == "LF")
            or cls in ("Control", "CR", "LF"))
        if join:
            join = (cls in ("Extend", "ZWJ", "SpacingMark") or prev == "Prepend"
                    or (prev == "L" and cls in ("L", "V", "LV", "LVT"))
                    or (prev in ("LV", "V") and cls in ("V", "T"))
                    or (prev in ("LVT", "T") and cls == "T")
                    or (prev == "RI" and cls == "RI" and ri % 2 == 1))
        if join:
            out[-1] += ch
        else:
            out.append(ch)
        ri = ri + 1 if cls == "RI" else 0
        prev = cls
    return out


class PrecompiledCharsmap:
    """A sentencepiece precompiled charsmap: a little-endian u32 trie size, a
    darts-clone double array of that many bytes over UTF-8 keys, then the
    NUL-ended normalized strings its values point into."""

    def __init__(self, blob: bytes):
        (size,) = struct.unpack_from("<I", blob, 0)
        self.units = np.frombuffer(blob, dtype="<u4", count=size // 4, offset=4).tolist()
        self.normalized = blob[4 + size:]

    def _first_prefix(self, key: bytes) -> Optional[int]:
        """darts-clone commonPrefixSearch's first (shortest) match, as
        spm_precompiled takes results[0]."""
        units = self.units
        pos = (units[0] >> 10) << ((units[0] & (1 << 9)) >> 6)
        for c in key:
            if c == 0:  # darts-clone keys end at NUL
                return None
            pos ^= c
            if pos >= len(units):
                return None
            unit = units[pos]
            if unit & ((1 << 31) | 0xFF) != c:
                return None
            pos ^= (unit >> 10) << ((unit & (1 << 9)) >> 6)
            if (unit >> 8) & 1:
                return units[pos] & ((1 << 31) - 1)
        return None

    def transform(self, chunk: str) -> Optional[str]:
        off = self._first_prefix(chunk.encode("utf-8"))
        if off is None:
            return None
        end = self.normalized.index(b"\0", off)
        return self.normalized[off:end].decode("utf-8")

    def __call__(self, text: str) -> str:
        """tokenizers' Precompiled normalizer: a grapheme of fewer than 6
        UTF-8 bytes is replaced whole by the normalization of its first
        matching prefix; otherwise each character is looked up alone."""
        out = []
        for g in graphemes(text):
            if len(g.encode("utf-8")) < 6:
                norm = self.transform(g)
                if norm is not None:
                    out.append(norm)
                    continue
            for ch in g:
                norm = self.transform(ch)
                out.append(ch if norm is None else norm)
        return "".join(out)


def build_precompiled_charsmap(mapping: Dict[str, str]) -> bytes:
    """The binary PrecompiledCharsmap reads (and tokenizers' Precompiled
    normalizer takes) for {key: normalized}: a darts-clone double array,
    each node's children placed at node ^ offset ^ label by a first-fit
    search, a key's value a unit with the top bit set under label 0. For
    synthetic tokenizer files."""
    norm = bytearray()
    root: dict = {}
    for key in sorted(mapping):
        node = root
        for b in key.encode("utf-8"):
            node = node.setdefault(b, {})
        node[0] = len(norm)
        norm += mapping[key].encode("utf-8") + b"\0"
    units = [0] * 256
    used = {0}
    queue = [(0, root)]
    while queue:
        pos, node = queue.pop(0)
        offset = 1
        while any(pos ^ offset ^ label in used for label in node):
            offset += 1
        if offset >= 1 << 21:
            raise ValueError("charsmap too large for this double-array layout")
        units[pos] |= offset << 10
        for label in sorted(node):
            q = pos ^ offset ^ label
            used.add(q)
            if q >= len(units):  # whole blocks of 256: a lookup of any byte stays inside
                units.extend([0] * ((q // 256 + 1) * 256 - len(units)))
            if label == 0:
                units[q] = node[0] | (1 << 31)
                units[pos] |= 1 << 8
            else:
                units[q] |= label
                queue.append((q, node[label]))
    trie = struct.pack(f"<{len(units)}I", *units)
    return struct.pack("<I", len(trie)) + trie + bytes(norm)


# ------------------------------------------------------ tokenizer.json (Unigram)


def _strip(text: str, left: bool, right: bool) -> str:
    ws = "".join(_WHITE_SPACE)
    if left:
        text = text.lstrip(ws)
    if right:
        text = text.rstrip(ws)
    return text


def _normalizer(spec: Optional[dict]):
    """A tokenizer.json normalizer as a str -> str function."""
    if spec is None:
        return lambda s: s
    kind = spec["type"]
    if kind == "Sequence":
        parts = [_normalizer(s) for s in spec["normalizers"]]

        def run(s):
            for p in parts:
                s = p(s)
            return s
        return run
    if kind == "Precompiled":
        cmap = spec.get("precompiled_charsmap")
        if not cmap:
            return lambda s: s
        return PrecompiledCharsmap(base64.b64decode(cmap))
    if kind == "Replace":
        pat, content = spec["pattern"], spec["content"]
        if "Regex" in pat:
            rx = re.compile(pat["Regex"])
            return lambda s: rx.sub(lambda m: content, s)
        return lambda s: s.replace(pat["String"], content)
    if kind == "NFKC":
        return lambda s: unicodedata.normalize("NFKC", s)
    if kind == "Strip":
        left, right = spec.get("strip_left", True), spec.get("strip_right", True)
        return lambda s: _strip(s, left, right)
    raise NotImplementedError(f"tokenizer.json normalizer {kind!r} is not supported")


def _pre_tokenizer(spec: Optional[dict]):
    """A tokenizer.json pre-tokenizer as (piece, at_origin) -> [words];
    at_origin says the piece starts the input text, for Metaspace's
    prepend_scheme "first"."""
    if spec is None:
        return lambda s, first: [s] if s else []
    kind = spec["type"]
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme") or (
            "always" if spec.get("add_prefix_space", True) else "never")
        do_split = spec.get("split", True)

        def meta(s, first):
            if not s:
                return []
            s = s.replace(" ", rep)
            if not s.startswith(rep) and (scheme == "always" or (scheme == "first" and first)):
                s = rep + s
            if not do_split:
                return [s]
            # split before each replacement character (MergedWithNext)
            cuts = [i for i, ch in enumerate(s) if ch == rep and i > 0]
            bounds = [0] + cuts + [len(s)]
            return [s[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
        return meta
    raise NotImplementedError(f"tokenizer.json pre-tokenizer {kind!r} is not supported")


class Unigram:
    """tokenizers' Unigram model: Viterbi over the pieces (each start's
    prefixes in order of length, a later one winning only on a strictly
    higher score), an unknown character at the lowest score - 10 when no
    piece of one character starts there, and consecutive unknowns fused
    into one unknown token."""

    UNK_PENALTY = 10.0

    def __init__(self, vocab: Sequence[Tuple[str, float]], unk_id: Optional[int]):
        self.pieces = {p.encode("utf-8"): (i, float(s)) for i, (p, s) in enumerate(vocab)}
        self.max_len = max(map(len, self.pieces), default=1)
        self.unk_id = unk_id
        self.unk_score = min((float(s) for _, s in vocab), default=0.0) - self.UNK_PENALTY

    def encode(self, text: str) -> List[int]:
        data = text.encode("utf-8")
        n = len(data)
        # the best path ending at each byte: score, where its last token starts, its id
        score, start, token = [0.0] * (n + 1), [-1] * (n + 1), [-1] * (n + 1)
        pos = 0
        while pos < n:
            base = score[pos]
            lead = data[pos]
            mblen = 1 if lead < 0x80 else 2 if lead < 0xE0 else 3 if lead < 0xF0 else 4
            single = False
            for end in range(pos + 1, min(n, pos + self.max_len) + 1):
                hit = self.pieces.get(data[pos:end])
                if hit is None:
                    continue
                cand = base + hit[1]
                if start[end] < 0 or cand > score[end]:
                    score[end], start[end], token[end] = cand, pos, hit[0]
                single = single or end - pos == mblen
            if not single:
                if self.unk_id is None:
                    raise ValueError("an unknown character and no unk_id in the Unigram model")
                end = pos + mblen
                cand = base + self.unk_score
                if start[end] < 0 or cand > score[end]:
                    score[end], start[end], token[end] = cand, pos, self.unk_id
            pos += mblen
        ids: List[int] = []
        end = n
        while end > 0:
            if not (token[end] == self.unk_id and ids and ids[-1] == self.unk_id):
                ids.append(token[end])
            end = start[end]
        return ids[::-1]


def _template(spec: Optional[dict]) -> List[Optional[List[int]]]:
    """The single-sequence template of a post-processor: None where the
    sequence goes, the ids of each special token elsewhere."""
    if spec is None:
        return [None]
    if spec["type"] != "TemplateProcessing":
        raise NotImplementedError(f"tokenizer.json post-processor {spec['type']!r} is not supported")
    out: List[Optional[List[int]]] = []
    for item in spec["single"]:
        if "Sequence" in item:
            out.append(None)
        else:
            out.append(list(spec["special_tokens"][item["SpecialToken"]["id"]]["ids"]))
    return out


class UnigramTokenizer:
    """A tokenizer.json with a Unigram model (T5TokenizerFast, and UMT5's
    AutoTokenizer, which resolves to it)."""

    def __init__(self, spec: dict, pad_token: str = "<pad>"):
        model = spec["model"]
        if model.get("type") != "Unigram" or model.get("byte_fallback"):
            raise NotImplementedError(
                f"tokenizer.json model {model.get('type')!r} (byte_fallback "
                f"{model.get('byte_fallback')}) is not supported; the port reads Unigram ones")
        vocab = [(p, s) for p, s in model["vocab"]]
        self.model = Unigram(vocab, model.get("unk_id"))
        self.normalize = _normalizer(spec.get("normalizer"))
        self.pre_tokenize = _pre_tokenizer(spec.get("pre_tokenizer"))
        self.template = _template(spec.get("post_processor"))
        self.n_added = sum(len(t) for t in self.template if t is not None)
        added = spec.get("added_tokens") or []
        if any(t.get("single_word") for t in added):
            raise NotImplementedError("single_word added tokens are not supported")
        self.added = {t["content"]: t for t in added}
        self.raw_re = self._matcher([t for t in added if not t.get("normalized")])
        self.norm_re = self._matcher([t for t in added if t.get("normalized")])
        ids = {p: i for i, (p, _) in enumerate(vocab)}
        ids.update({t["content"]: t["id"] for t in added})
        self.pad_id = ids.get(pad_token, 0)

    @classmethod
    def from_dir(cls, path: str) -> "UnigramTokenizer":
        pad = _special_tokens(path).get("pad_token", "<pad>")
        return cls(_read_json(os.path.join(path, "tokenizer.json")), pad)

    @staticmethod
    def _matcher(tokens: List[dict]):
        """Leftmost-longest matching of the added tokens (the crate's
        Aho-Corasick), or None."""
        if not tokens:
            return None
        words = sorted((t["content"] for t in tokens), key=len, reverse=True)
        return re.compile("|".join(re.escape(w) for w in words))

    def _split_added(self, text: str, rx, at_origin: bool):
        """[(piece, added token id or None, piece starts the text)], the
        added tokens' lstrip / rstrip eating white space."""
        if rx is None:
            return [(text, None, at_origin)]
        out, pos = [], 0
        for m in rx.finditer(text):
            tok = self.added[m.group()]
            a, b = m.span()
            if tok.get("lstrip"):
                while a > pos and text[a - 1] in _WHITE_SPACE:
                    a -= 1
            if tok.get("rstrip"):
                while b < len(text) and text[b] in _WHITE_SPACE:
                    b += 1
            if a > pos:
                out.append((text[pos:a], None, at_origin and pos == 0))
            out.append((m.group(), tok["id"], False))
            pos = b
        if pos < len(text):
            out.append((text[pos:], None, at_origin and pos == 0))
        return out

    def encode(self, text: str) -> List[int]:
        """The ids of one prompt, without the template's tokens."""
        ids: List[int] = []
        for piece, tid, first in self._split_added(text, self.raw_re, True):
            if tid is not None:
                ids.append(tid)
                continue
            for sub, sid, sfirst in self._split_added(self.normalize(piece), self.norm_re, first):
                if sid is not None:
                    ids.append(sid)
                    continue
                for word in self.pre_tokenize(sub, sfirst):
                    ids.extend(self.model.encode(word))
        return ids

    def __call__(self, prompt, max_length: int) -> Tuple[np.ndarray, np.ndarray]:
        rows = []
        for p in _as_list(prompt):
            seq = self.encode(p)[:max(0, max_length - self.n_added)]
            rows.append([i for t in self.template for i in (seq if t is None else t)])
        return _pad(rows, max_length, self.pad_id)


def load_tokenizer(path: str):
    """The tokenizer of a diffusers tokenizer*/ directory: CLIP's BPE
    (vocab.json + merges.txt) or a Unigram tokenizer.json."""
    if os.path.exists(os.path.join(path, "vocab.json")) and \
            os.path.exists(os.path.join(path, "merges.txt")):
        return CLIPTokenizer.from_dir(path)
    if os.path.exists(os.path.join(path, "tokenizer.json")):
        return UnigramTokenizer.from_dir(path)
    raise FileNotFoundError(f"no tokenizer in {path!r}: expected vocab.json + merges.txt "
                            "(CLIP) or tokenizer.json (T5 / UMT5)")


# ------------------------------------------------------------------ writers


def _write_json(path: str, obj) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f, ensure_ascii=False)


def save_clip_tokenizer(path: str, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]],
                        pad_token: str = "<|endoftext|>") -> None:
    """vocab.json, merges.txt and the token files of a CLIP tokenizer
    directory, as transformers' CLIPTokenizer reads them (synthetic
    checkpoints)."""
    os.makedirs(path, exist_ok=True)
    _write_json(os.path.join(path, "vocab.json"), vocab)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    special = dict(bos_token="<|startoftext|>", eos_token="<|endoftext|>",
                   unk_token="<|endoftext|>", pad_token=pad_token)
    _write_json(os.path.join(path, "special_tokens_map.json"), special)
    _write_json(os.path.join(path, "tokenizer_config.json"),
                dict(special, tokenizer_class="CLIPTokenizer", model_max_length=77))


def save_unigram_tokenizer(path: str, vocab: Sequence[Tuple[str, float]],
                           charsmap: Optional[Dict[str, str]] = None, unk_id: int = 2,
                           pad_id: int = 0, eos_id: int = 1) -> None:
    """A T5-style tokenizer.json (Precompiled charsmap + Replace(" {2,}",
    " "), Metaspace, Unigram, "$A </s>") and its token files, as
    T5TokenizerFast / AutoTokenizer read them (synthetic checkpoints)."""
    os.makedirs(path, exist_ok=True)
    names = {i: vocab[i][0] for i in (unk_id, pad_id, eos_id)}
    added = [dict(id=i, content=c, single_word=False, lstrip=False, rstrip=False,
                  normalized=False, special=True) for i, c in sorted(names.items())]
    norms = [{"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "}]
    if charsmap:
        blob = base64.b64encode(build_precompiled_charsmap(charsmap)).decode("ascii")
        norms.insert(0, {"type": "Precompiled", "precompiled_charsmap": blob})
    meta = {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always", "split": True}
    eos = names[eos_id]
    seq, tok = {"Sequence": {"id": "A", "type_id": 0}}, {"SpecialToken": {"id": eos, "type_id": 0}}
    spec = {"version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
            "normalizer": {"type": "Sequence", "normalizers": norms}, "pre_tokenizer": meta,
            "post_processor": {"type": "TemplateProcessing", "single": [seq, tok],
                               "pair": [seq, tok, {"Sequence": {"id": "B", "type_id": 0}}, tok],
                               "special_tokens": {eos: {"id": eos, "ids": [eos_id],
                                                        "tokens": [eos]}}},
            "decoder": meta,
            "model": {"type": "Unigram", "unk_id": unk_id, "byte_fallback": False,
                      "vocab": [[p, float(s)] for p, s in vocab]}}
    _write_json(os.path.join(path, "tokenizer.json"), spec)
    special = dict(eos_token=eos, unk_token=names[unk_id], pad_token=names[pad_id])
    _write_json(os.path.join(path, "special_tokens_map.json"), special)
    _write_json(os.path.join(path, "tokenizer_config.json"),
                dict(special, tokenizer_class="T5Tokenizer", extra_ids=0,
                     additional_special_tokens=[], model_max_length=512))
