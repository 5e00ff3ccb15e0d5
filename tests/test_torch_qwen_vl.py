"""The port's Qwen2.5-VL prompt encoder pieces against transformers (the JAX
package's QwenImageTextEncoder runs transformers' modules on the host,
fastdm_tpu/pipeline/text_encoder.py:234-333) on a vocabulary and tiny
models this file writes:

  * the byte-level BPE tokenizer's ids bit-exact with AutoTokenizer
    (Qwen2TokenizerFast) on a tokenizer.json written by save_bpe_tokenizer
    and on the slow vocab.json + merges.txt layout without one: the specials at Qwen's ids and after the vocab, the chat templates,
    padding on either side, truncation, and a derandomized hypothesis sweep
    over CJK, digits, accents, CR / LF runs and trailing spaces; qwen2_split
    held to regex.findall of transformers' PRETOKENIZE_REGEX; the BPE
    merges to the tokenizers crate's BPE model on merges in any rank order;
  * the language model's hidden_states[-1] and the vision tower (partial
    edge windows, a full-attention block) within relative L2 1e-5 of
    Qwen2_5_VLForConditionalGeneration in f32, padded batches on both sides
    (every row against the eager mask; the valid rows against sdpa, which
    zeroes a row that sees no key), a plain Qwen2ForCausalLM; get_rope_index
    equal, text only and with one or two images a row;
  * the Qwen2-VL preprocessing's pixel_values / image_grid_thw bit for bit
    with Qwen2VLImageProcessor (round ties, both pixel-limit branches) and
    the image-pad expansion with Qwen2_5_VLProcessor's;
  * the loader on both key layouts, sharded, strict; the writers read back
    by transformers.

The encoder class against the JAX class, and the engine, are in
tests/test_torch_qwen_text_engine.py."""

import json
import os
import sys
from collections import Counter

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from fastdm_tpu_torch.models import qwen2_5_vl as tvl
from fastdm_tpu_torch.models.loader import TensorSource
from fastdm_tpu_torch.pipeline import image_processor as tip
from fastdm_tpu_torch.pipeline import tokenizers as ttok

sys.path.insert(0, os.path.dirname(__file__))
from torch_threads import torch_threads_per_worker  # noqa: E402,F401  (autouse)

REL_L2 = 1e-5
CORPUS = ("Describe the image by detailing the color, shape, size, texture, quantity, text, "
          "spatial relationships of the objects and background: a photo of a cat sitting on "
          "the mat. Describe the key features of the input image (color, shape, size, "
          "texture, objects, background), then explain how the user's text instruction "
          "should alter or modify the image. Generate a new image that meets the user's "
          "requirements while maintaining consistency with the original input where "
          "appropriate. It's 100% real: 日本語のテキスト café naïve Ångström\n\n  end")
TEMPLATE = ("<|im_start|>system\nDescribe the image by detailing the color:<|im_end|>\n"
            "<|im_start|>user\n{}<|im_end|>\n<|im_start|>assistant\n")
PROMPTS = [
    TEMPLATE.format("a photo of a cat"),
    "<|im_start|>user\n<|vision_start|><|image_pad|><|image_pad|><|vision_end|>make it "
    "snow<|im_end|>\n",
    "a photo of a cat", "", " ", "  ",
    "Ｃafé é 日本語  two  spaces\r\n\r\nend  ",
    "x'S it'LL we're I'M 12345 ½² ①",
    "tabs\t\tand nbsp　ideographic  sep",
    "<|endoftext|>tail<|im_end|><|im_end|>",
    "Picture 1: <|vision_start|><|image_pad|><|vision_end|>Picture 2: <|vision_start|>"
    "<|image_pad|><|vision_end|>",
    " ".join(["a majestic castle on a hill at dawn, ultra detailed, 8k"] * 6),
]
# first added id of the tiny models' tokenizer: right after the vocab
ADDED = list(ttok.QWEN2_VL_ADDED_TOKENS)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ------------------------------------------------------------------ tokenizer


def train_bpe(texts, n_merges: int):
    """A tiny byte-level BPE trainer over qwen2_split's words: the 256 byte
    symbols, the most frequent pair merged first."""
    enc = ttok.bytes_to_unicode()
    seqs = Counter(tuple(enc[b] for b in w.encode()) for t in texts for w in ttok.qwen2_split(t))
    merges = []
    for _ in range(n_merges):
        pairs = Counter()
        for s, c in seqs.items():
            for p in zip(s[:-1], s[1:]):
                pairs[p] += c
        if not pairs:
            break
        best = max(sorted(pairs), key=lambda p: pairs[p])
        merges.append(best)
        new = Counter()
        for s, c in seqs.items():
            out, i = [], 0
            while i < len(s):
                if i < len(s) - 1 and (s[i], s[i + 1]) == best:
                    out.append(s[i] + s[i + 1])
                    i += 2
                else:
                    out.append(s[i])
                    i += 1
            new[tuple(out)] += c
        seqs = new
    vocab = list(dict.fromkeys(list(enc.values()) + ["".join(m) for m in merges]))
    return {t: i for i, t in enumerate(vocab)}, merges


VOCAB, MERGES = train_bpe([CORPUS] + PROMPTS[:3], 300)
FIRST = len(VOCAB)  # the tiny models' added tokens follow the vocab
IDS = {t: FIRST + i for i, t in enumerate(ADDED)}


def write_qwen_tokenizer(path: str, padding_side=None) -> str:
    ttok.save_bpe_tokenizer(path, VOCAB, MERGES, padding_side=padding_side)
    return path


@pytest.mark.parametrize("side", [None, "left"], ids=["right", "left"])
def test_bpe_tokenizer_ids_bit_exact(tmp_path, side):
    from transformers import AutoTokenizer

    first = FIRST
    path = write_qwen_tokenizer(str(tmp_path / "tok"), side)
    want = AutoTokenizer.from_pretrained(path)
    assert type(want).__name__ == "Qwen2TokenizerFast"
    got = ttok.load_tokenizer(path)
    assert isinstance(got, ttok.ByteLevelBPETokenizer)
    assert got.pad_id == want.pad_token_id == first and got.padding_side == want.padding_side
    for p in PROMPTS:
        assert got.encode(p) == want(p).input_ids, p
    for kw in (dict(max_length=None), dict(max_length=24)):
        ref = want(PROMPTS, padding=True, truncation=kw["max_length"] is not None,
                   return_tensors="np", **kw)
        ids, mask = got(PROMPTS, kw["max_length"])
        np.testing.assert_array_equal(ids, ref.input_ids)
        np.testing.assert_array_equal(mask, ref.attention_mask)
    left = side == "left"  # "a photo of a cat" is a short row
    assert ids.shape == (len(PROMPTS), 24) and mask[2, -1] == left and mask[2, 0] == (not left)


def test_bpe_tokenizer_slow_layout_ids_bit_exact(tmp_path):
    """The slow Qwen2Tokenizer's layout (vocab.json + merges.txt, the added
    tokens in tokenizer_config.json, no tokenizer.json), as a slow
    save_pretrained writes it: read as Qwen2's byte-level BPE, never as
    CLIP's, and equal to AutoTokenizer, which converts it to
    Qwen2TokenizerFast."""
    from transformers import AutoTokenizer, Qwen2Tokenizer

    files = write_qwen_tokenizer(str(tmp_path / "files"))
    os.remove(os.path.join(files, "tokenizer.json"))
    with open(os.path.join(files, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(VOCAB, f, ensure_ascii=False)
    with open(os.path.join(files, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in MERGES))
    slow = str(tmp_path / "slow")
    Qwen2Tokenizer.from_pretrained(files).save_pretrained(slow)
    assert not os.path.exists(os.path.join(slow, "tokenizer.json"))
    assert os.path.exists(os.path.join(slow, "merges.txt"))
    want = AutoTokenizer.from_pretrained(slow)
    assert type(want).__name__ == "Qwen2TokenizerFast"
    got = ttok.load_tokenizer(slow)
    assert isinstance(got, ttok.ByteLevelBPETokenizer) and got.pad_id == want.pad_token_id
    for p in PROMPTS + [CORPUS]:
        assert got.encode(p) == want(p).input_ids, p
    ref = want(PROMPTS, padding=True, return_tensors="np")
    ids, mask = got(PROMPTS)
    np.testing.assert_array_equal(ids, ref.input_ids)
    np.testing.assert_array_equal(mask, ref.attention_mask)
    cfg_path = os.path.join(slow, "tokenizer_config.json")
    with open(cfg_path) as f:
        cfg = json.load(f)
    del cfg["added_tokens_decoder"]
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    with pytest.raises(NotImplementedError, match="added_tokens_decoder"):
        ttok.load_tokenizer(slow)
    cfg["tokenizer_class"] = "GPT2Tokenizer"
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    with pytest.raises(NotImplementedError, match="GPT2Tokenizer"):
        ttok.load_tokenizer(slow)


_ALPHABET = ("abcdefgxyzABCXYZ" "0123456789½²" "日本語中文字符テキ" "éèüñÅßœ́̈"
             "'.,:;!?()-%#@" + " " * 6 + "\r\n\t 　 \x1c")
_TEXT = st.lists(st.one_of(st.sampled_from(_ALPHABET), st.sampled_from(
    ["'s", "'LL", "'re", "\r\n", "  ", "<|im_end|>", "<|image_pad|>", "cat", " cat"])),
    max_size=24).map("".join)


@settings(max_examples=150, derandomize=True, deadline=None)
@given(text=_TEXT)
def test_bpe_tokenizer_matches_transformers_on_drawn_text(text):
    tok = _drawn_tokenizers()
    assert tok[0].encode(text) == tok[1](text).input_ids


_DRAWN = {}


def _drawn_tokenizers():
    if not _DRAWN:
        import tempfile

        from transformers import AutoTokenizer

        path = write_qwen_tokenizer(tempfile.mkdtemp(prefix="qwen-tok-"))
        _DRAWN["pair"] = (ttok.load_tokenizer(path), AutoTokenizer.from_pretrained(path))
    return _DRAWN["pair"]


@settings(max_examples=300, derandomize=True, deadline=None)
@given(text=_TEXT)
def test_qwen2_split_matches_regex(text):
    import regex
    from transformers.models.qwen2.tokenization_qwen2 import PRETOKENIZE_REGEX

    assert ttok.QWEN2_SPLIT_PATTERN == PRETOKENIZE_REGEX
    assert ttok.qwen2_split(text) == regex.findall(PRETOKENIZE_REGEX, text)


def test_qwen2_split_backtracking_cases():
    """\\s+(?!\\S) leaves a run's last space to the next word; a run at the end
    is whole; \\s*[\\r\\n]+ ends at the run's last CR / LF."""
    assert ttok.qwen2_split("a  b") == ["a", " ", " b"]
    assert ttok.qwen2_split("a   ") == ["a", "   "]
    assert ttok.qwen2_split("a \n \n  b") == ["a", " \n \n", " ", " b"]
    assert ttok.qwen2_split("it's x'LL ſ'ſt") == ["it", "'s", " x", "'LL", " ſ", "'ſ", "t"]
    assert ttok.qwen2_split("ab12 ?!\n\nx") == ["ab", "1", "2", " ?!\n\n", "x"]


def test_bpe_merges_match_the_crate_in_any_rank_order():
    """Merges whose products pair up at lower ranks than pending pairs: the
    crate merges one pair at a time (lowest rank, then leftmost) and queues
    the new pairs; BytePairEncoding does the same."""
    from tokenizers.models import BPE

    rng = np.random.default_rng(3)
    for trial in range(30):
        symbols = list("abcd")
        vocab = {s: i for i, s in enumerate(symbols)}
        merges = []
        while len(merges) < 12:
            a, b = rng.choice(list(vocab)), rng.choice(list(vocab))
            if len(a + b) <= 4 and a + b not in vocab:
                vocab[a + b] = len(vocab)
                merges.append((a, b))
        order = rng.permutation(len(merges))  # ranks unrelated to the products' order
        merges = [merges[i] for i in order]
        ref = BPE(vocab, merges)
        port = ttok.BytePairEncoding(vocab, merges)
        for _ in range(40):
            word = "".join(rng.choice(symbols, rng.integers(1, 10)))
            assert port.encode(word) == [t.id for t in ref.tokenize(word)], (trial, word)


# ------------------------------------------------------------------ models

TEXT = dict(hidden_size=24, intermediate_size=40, num_hidden_layers=2, num_attention_heads=2,
            num_key_value_heads=1, vocab_size=FIRST + len(ADDED) + 3, rms_norm_eps=1e-6,
            rope_theta=1e6, max_position_embeddings=4096)
MROPE = [2, 2, 2]
VISION = dict(depth=3, hidden_size=16, intermediate_size=24, num_heads=2, out_hidden_size=24,
              fullatt_block_indexes=[1], window_size=112, patch_size=14, spatial_merge_size=2,
              temporal_patch_size=2)


def hf_config(vision: bool = True):
    from transformers import Qwen2_5_VLConfig, Qwen2Config

    if not vision:
        return Qwen2Config(**TEXT, tie_word_embeddings=False)
    return Qwen2_5_VLConfig(
        text_config=dict(TEXT, rope_scaling={"type": "mrope", "mrope_section": MROPE}),
        vision_config=VISION, image_token_id=IDS["<|image_pad|>"],
        video_token_id=IDS["<|video_pad|>"], vision_start_token_id=IDS["<|vision_start|>"],
        vision_end_token_id=IDS["<|vision_end|>"])


def hf_model(seed: int, vision: bool = True, attn: str = "sdpa"):
    """transformers' Qwen2_5_VLForConditionalGeneration (or Qwen2ForCausalLM)
    at the tiny config, weights N(0, 0.3²) (norms 1 + N(0, 0.1²)) from a seed."""
    from transformers import Qwen2_5_VLForConditionalGeneration, Qwen2ForCausalLM

    torch.manual_seed(seed)
    cls = Qwen2_5_VLForConditionalGeneration if vision else Qwen2ForCausalLM
    model = cls._from_config(hf_config(vision), attn_implementation=attn).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name or "ln_q" in name:
                p.copy_(1 + 0.1 * torch.randn_like(p))
            else:
                p.normal_(0, 0.3)
    return model


def write_text_encoder(path: str, seed: int, vision: bool = True) -> str:
    hf_model(seed, vision).save_pretrained(path)
    return path


def _port(hf, tmp_path, name="te"):
    path = str(tmp_path / name)
    hf.save_pretrained(path)
    cfg = tvl.Qwen2_5_VLConfig.from_dir(path)
    return tvl.qwen2_5_vl_load(TensorSource.from_path(path, "cpu"), cfg)


def _batch(rows, pad_id: int, left: bool):
    n = max(map(len, rows))
    ids = np.full((len(rows), n), pad_id, np.int64)
    mask = np.zeros((len(rows), n), np.int64)
    for i, r in enumerate(rows):
        span = slice(n - len(r), n) if left else slice(0, len(r))
        ids[i, span], mask[i, span] = r, 1
    return ids, mask


@pytest.mark.parametrize("left", [False, True], ids=["right-pad", "left-pad"])
def test_language_model_matches_transformers(tmp_path, left):
    """hidden_states[-1] of a padded batch: every row within 1e-5 of the
    eager model (finfo.min masks: a left pad row that sees no key averages
    all keys, finitely); the valid rows of sdpa's."""
    rng = np.random.default_rng(5)
    rows = [rng.integers(0, FIRST, n).tolist() for n in (13, 7, 1)]
    ids, mask = _batch(rows, IDS["<|endoftext|>"], left)
    eager = hf_model(11, attn="eager")
    port = _port(eager, tmp_path)
    got = port(ids, mask)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    with torch.no_grad():
        want = eager(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
                     output_hidden_states=True).hidden_states[-1]
        sdpa = hf_model(11)(input_ids=torch.from_numpy(ids),
                            attention_mask=torch.from_numpy(mask),
                            output_hidden_states=True).hidden_states[-1]
    assert _rel_l2(got, want) <= REL_L2
    valid = torch.from_numpy(mask).bool()
    assert _rel_l2(got[valid], sdpa[valid]) <= REL_L2


def test_plain_qwen2_text_encoder_matches_transformers(tmp_path):
    """A qwen2 text_encoder/ (the reference's AutoModelForCausalLM branch):
    1-D RoPE on arange positions, right padding."""
    hf = hf_model(12, vision=False)
    port = _port(hf, tmp_path)
    assert port.cfg.vision is None and port.cfg.mrope_section is None
    rng = np.random.default_rng(6)
    ids, mask = _batch([rng.integers(0, FIRST, n).tolist() for n in (9, 4)],
                       IDS["<|endoftext|>"], False)
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
                  output_hidden_states=True).hidden_states[-1]
    assert _rel_l2(port(ids, mask), want) <= REL_L2


# two images: 10 x 14 patches (5 x 7 merged units: windows of 4 x 4 with
# partial edges) and 6 x 4 (3 x 2: one partial window)
GRID = np.array([[1, 10, 14], [1, 6, 4]])


def _image_rows(rng, images_per_row):
    """Token rows with each image behind <|vision_start|> as its pads."""
    rows, k = [], 0
    for n in images_per_row:
        r = rng.integers(0, FIRST, 3).tolist()
        for _ in range(n):
            r += [IDS["<|vision_start|>"]] + [IDS["<|image_pad|>"]] * int(GRID[k].prod() // 4)
            r += [IDS["<|vision_end|>"]] + rng.integers(0, FIRST, 2).tolist()
            k += 1
        rows.append(r + rng.integers(0, FIRST, int(rng.integers(1, 5))).tolist())
    return rows


@pytest.mark.parametrize("layout", [(1, 1), (2, 0), (0, 2)], ids=["one-each", "two-then-none",
                                                                   "none-then-two"])
def test_get_rope_index_equal(layout):
    from transformers import Qwen2_5_VLModel

    model = Qwen2_5_VLModel(hf_config())
    cfg = tvl.Qwen2_5_VLConfig.from_json(hf_config().to_dict())
    rng = np.random.default_rng(7)
    for left in (False, True):
        ids, mask = _batch(_image_rows(rng, layout), IDS["<|endoftext|>"], left)
        want, _ = model.get_rope_index(torch.from_numpy(ids), torch.from_numpy(GRID), None, None,
                                       torch.from_numpy(mask))
        assert torch.equal(tvl.get_rope_index(cfg, ids, GRID, mask), want)
    want, _ = model.get_rope_index(torch.from_numpy(ids), None, None, None, torch.from_numpy(mask))
    assert torch.equal(tvl.get_rope_index(cfg, ids, None, mask), want)  # text only


def test_vision_tower_matches_transformers(tmp_path):
    hf = hf_model(13)
    port = _port(hf, tmp_path)
    pixels = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (int(GRID.prod(1).sum()), 3 * 2 * 14 * 14)).astype(np.float32))
    with torch.no_grad():
        want = hf.model.visual(pixels, grid_thw=torch.from_numpy(GRID))
    got = tvl.qwen2_5_vl_vision_forward(port, pixels, GRID)
    assert got.shape == (int(GRID.prod(1).sum()) // 4, 24)
    assert _rel_l2(got, want) <= REL_L2
    window_index, cu = tvl.vision_window_index(port.cfg.vision, GRID)
    assert sorted(window_index.tolist()) == list(range(41)) and cu[-1] == 164


def test_vl_forward_with_images_matches_transformers(tmp_path):
    """The image rows scattered in order, the M-RoPE positions, padded rows."""
    hf = hf_model(14)
    port = _port(hf, tmp_path)
    rng = np.random.default_rng(9)
    ids, mask = _batch(_image_rows(rng, (1, 1)), IDS["<|endoftext|>"], False)
    pixels = torch.from_numpy(rng.standard_normal(
        (int(GRID.prod(1).sum()), 1176)).astype(np.float32))
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
                  pixel_values=pixels, image_grid_thw=torch.from_numpy(GRID),
                  output_hidden_states=True).hidden_states[-1]
    assert _rel_l2(port(ids, mask, pixels, GRID), want) <= REL_L2
    with pytest.raises(ValueError, match="Image features and image tokens"):
        port(ids[:, :-3], mask[:, :-3], pixels[:140], GRID[:1])


# ------------------------------------------------------------------ preprocessing


def _image(seed, h, w):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


# (h, w, min_pixels, max_pixels): the published limits, round ties
# (70 / 28 = 2.5, 98 / 28 = 3.5, 154 / 28 = 5.5), the min_pixels branch and
# the max_pixels branch
SIZES = [(1024, 1024, 3136, 12845056), (70, 42, 3136, 12845056), (98, 154, 3136, 12845056),
         (30, 40, 3136, 1003520), (500, 300, 3136, 28 * 28 * 40),
         (14, 300, 56 * 56, 28 * 28 * 1280)]


@pytest.mark.parametrize("h,w,lo,hi", SIZES)
def test_qwen2vl_preprocessing_bit_exact(h, w, lo, hi):
    from transformers import Qwen2VLImageProcessor
    from transformers.models.qwen2_vl.image_processing_qwen2_vl import smart_resize

    assert tip.smart_resize(h, w, 28, lo, hi) == smart_resize(h, w, 28, lo, hi)
    images = [_image(h + w, h, w), _image(1, h // 2 + 30, w)]
    ref = Qwen2VLImageProcessor(min_pixels=lo, max_pixels=hi)(images=images, return_tensors="np")
    pixels, grid = tip.Qwen2VLImageProcessor(min_pixels=lo, max_pixels=hi)(images)
    assert pixels.dtype == ref.pixel_values.dtype == np.float32
    np.testing.assert_array_equal(pixels, ref.pixel_values)
    np.testing.assert_array_equal(grid, ref.image_grid_thw)


def test_processor_config_round_trip_and_pad_expansion(tmp_path):
    """save() is read by transformers with the same settings (the slow
    constructor keeps min_pixels / max_pixels, ignoring `size`); the
    image-pad expansion is Qwen2_5_VLProcessor's loop."""
    from transformers import Qwen2VLImageProcessor

    mine = tip.Qwen2VLImageProcessor(min_pixels=3136, max_pixels=12845056)
    mine.save(str(tmp_path))
    ref = Qwen2VLImageProcessor.from_pretrained(str(tmp_path))
    assert (ref.min_pixels, ref.max_pixels, ref.patch_size, ref.merge_size) == \
        (3136, 12845056, 14, 2)
    back = tip.Qwen2VLImageProcessor.from_dir(str(tmp_path))
    assert vars(back) == vars(mine)
    texts = ["a <|image_pad|> b <|image_pad|>", "none", "<|image_pad|>"]
    grid = np.array([[1, 4, 6], [1, 2, 2], [1, 10, 14]])
    want = []
    k = 0
    for t in texts:  # transformers' processing_qwen2_5_vl.py loop
        while "<|image_pad|>" in t:
            t = t.replace("<|image_pad|>", "<|placeholder|>" * int(grid[k].prod() // 4), 1)
            k += 1
        want.append(t.replace("<|placeholder|>", "<|image_pad|>"))
    assert tip.expand_image_pads(texts, grid) == want
    with pytest.raises(ValueError, match="image tokens"):
        tip.expand_image_pads(texts + ["<|image_pad|>"], grid)


# ------------------------------------------------------------------ loader, writers


def test_loader_reads_both_layouts_sharded_and_strictly(tmp_path):
    from safetensors.torch import load_file, save_file

    hf = hf_model(15)
    pub = str(tmp_path / "published")
    hf.save_pretrained(pub)
    cfg = tvl.Qwen2_5_VLConfig.from_dir(pub)
    a = tvl.qwen2_5_vl_load(TensorSource.from_path(pub, "cpu"), cfg)
    sd = load_file(os.path.join(pub, "model.safetensors"))
    assert "lm_head.weight" in sd and any(k.startswith("visual.") for k in sd)
    new = {("model.language_model." + k[6:] if k.startswith("model.") else
            "model." + k if k.startswith("visual.") else k): v for k, v in sd.items()}
    names = sorted(new)
    half = len(names) // 2
    os.makedirs(tmp_path / "new")
    save_file({k: new[k] for k in names[:half]}, str(tmp_path / "new" / "a.safetensors"))
    save_file({k: new[k] for k in names[half:]}, str(tmp_path / "new" / "b.safetensors"))
    b = tvl.qwen2_5_vl_load(TensorSource.from_path(str(tmp_path / "new"), "cpu"), cfg)
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    assert "lm_head.weight" not in a.state_dict()
    extra = dict(sd, **{"model.extra.weight": torch.zeros(1)})
    with pytest.raises(ValueError, match="never consumed"):
        tvl.qwen2_5_vl_load(TensorSource(extra, "cpu"), cfg)
    missing = {k: v for k, v in sd.items() if k != "visual.merger.ln_q.weight"}
    with pytest.raises(KeyError, match="ln_q"):
        tvl.qwen2_5_vl_load(TensorSource(missing, "cpu"), cfg)


def test_config_forms():
    """transformers' nested config.json, the published flat one, a qwen2 one."""
    nested = hf_config().to_dict()
    a = tvl.Qwen2_5_VLConfig.from_json(nested)
    flat = dict(nested.pop("text_config"), **nested)
    flat["rope_scaling"] = {"type": "mrope", "mrope_section": MROPE}
    flat["vision_config"] = dict(flat["vision_config"], in_chans=3)
    assert tvl.Qwen2_5_VLConfig.from_json(flat) == a == tvl.Qwen2_5_VLConfig.from_json(
        a.to_json())
    assert a.mrope_section == tuple(MROPE) and a.vision.fullatt_block_indexes == (1,)
    assert a.image_token_id == IDS["<|image_pad|>"]
    plain = tvl.Qwen2_5_VLConfig.from_json(hf_config(False).to_dict())
    assert plain.vision is None and plain.mrope_section is None
    assert tvl.Qwen2_5_VLConfig() == tvl.Qwen2_5_VLConfig.from_json(
        tvl.Qwen2_5_VLConfig().to_json())  # Qwen2.5-VL-7B's widths


def test_written_encoder_read_by_transformers(tmp_path):
    """qwen2_5_vl_init_random -> save_text_encoder (f32: the published key
    layout and flat config, no lm_head) -> transformers' from_pretrained
    gives the port's hidden states; a qwen2 config is not written."""
    from transformers import AutoModelForImageTextToText

    from fastdm_tpu_torch.pipeline.text_encoder import save_text_encoder

    cfg = tvl.Qwen2_5_VLConfig.from_json(hf_config().to_dict())
    model = tvl.qwen2_5_vl_init_random(3, cfg, device="cpu")
    path = str(tmp_path / "te")
    save_text_encoder(model, path, torch.float32)
    with open(os.path.join(path, "config.json")) as f:
        written = json.load(f)
    assert "vision_config" in written and "text_config" not in written
    with pytest.raises(ValueError, match="only a Qwen2.5-VL config"):
        tvl.Qwen2_5_VLConfig.from_json(hf_config(False).to_dict()).to_json()
    hf = AutoModelForImageTextToText.from_pretrained(path, torch_dtype=torch.float32).eval()
    ids, mask = _batch([[1, 2, 3, 4, 5], [6, 7]], IDS["<|endoftext|>"], False)
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
                  output_hidden_states=True).hidden_states[-1]
    got = model(ids, mask)
    valid = torch.from_numpy(mask).bool()
    assert _rel_l2(got[valid], want[valid]) <= REL_L2


def test_entry_points_default_to_the_card(tmp_path):
    from fastdm_tpu_torch.pipeline.text_encoder import QwenImageTextEncoder

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device is valid here")
    cfg = tvl.Qwen2_5_VLConfig.from_json(hf_config().to_dict())
    for call in (lambda: tvl.qwen2_5_vl_init_random(0, cfg),
                 lambda: QwenImageTextEncoder(str(tmp_path))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
