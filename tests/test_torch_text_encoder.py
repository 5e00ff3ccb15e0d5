"""The port's prompt tokenizers and text encoders against transformers (the
JAX package's encoders run transformers' modules, fastdm_tpu/pipeline/
text_encoder.py) on vocabularies and tiny models this file writes:

  * token ids bit-exact with transformers' slow CLIPTokenizer (both pad
    tokens, the no-ftfy branch) and with T5TokenizerFast / AutoTokenizer on
    Unigram tokenizer.json files (a Precompiled charsmap, Replace, Strip,
    NFKC; the Metaspace prepend schemes) over ASCII, punctuation, ½², CJK,
    accents, double spaces, "", " ", a literal </s> and prompts past 77 and
    512 tokens;
  * the Precompiled charsmap reader against tokenizers.normalizers.Precompiled
    on a charsmap written by the port's darts-clone writer;
  * CLIPTextModel / CLIPTextModelWithProjection (eos_token_id 2 and 49407),
    T5EncoderModel and UMT5EncoderModel (with and without a padding mask,
    sharded, either embedding name) within relative L2 1e-5 in f32.

The four encoder classes against the JAX classes, and the engine, are in
tests/test_torch_text_engine.py."""

import json
import os
import shutil
import sys
import tempfile
from collections import Counter
from functools import lru_cache

import numpy as np
import pytest
import torch

from fastdm_tpu_torch.pipeline import tokenizers as ttok

sys.path.insert(0, os.path.dirname(__file__))
from torch_threads import torch_threads_per_worker  # noqa: E402,F401  (autouse)

CORPUS = ("a photo of a cat sitting on the mat with a hat , the dog and the bird are "
          "playing in the garden under the sun ; an astronaut riding a horse on mars "
          "high quality detailed painting of mountains lake forest sunset cinematic "
          "portrait woman man city street night neon lights rain reflection don't "
          "it's we're you'll they've i'm he'd café naïve façade résumé")
LONG = " ".join(["a majestic castle on a hill at dawn, ultra detailed, 8k"] * 20)
PROMPTS = [
    "a photo of a cat",
    "A Photo, of: a CAT!!! (sitting) on-the-mat. #tag @user $5 100% 3.14",
    "½² and x² ≥ 3½ ⅓ ⅷ ①",
    "日本語のテキストと漢字、中文字符",
    "café naïve façade résumé Ångström Œuvre ß",
    "café decomposed é and Å",
    "two  spaces   and\ttab\nnewline\r\nend",
    "",
    " ",
    "literal </s> eos and <|endoftext|> and <pad> here",
    "hello! wow!! ! !x",
    "don't you'll we're it's I'M HE'D 'S",
    "ＡＢＣ full width … ellipsis nbsp ﬁne",
    "mixed​zero‍width \x00nul �\u0007bell",
    "<sep>start a  <sep>  b ＳＥＰ and ＳＥＰ<sep>",
    LONG,
    " ".join([LONG] * 4),
]


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ------------------------------------------------------------------ CLIP BPE


def _train_bpe(words, n_merges):
    """A tiny byte-level BPE trainer: CLIP's symbols (bytes mapped to
    printable characters, "</w>" on a word's last), the most frequent pair
    merged first."""
    enc = ttok.bytes_to_unicode()
    counts = Counter(tuple(enc[b] for b in w.encode()) for w in words)
    seqs = {k[:-1] + (k[-1] + "</w>",): c for k, c in counts.items()}
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
        new = {}
        for s, c in seqs.items():
            out, i = [], 0
            while i < len(s):
                if i < len(s) - 1 and (s[i], s[i + 1]) == best:
                    out.append(s[i] + s[i + 1])
                    i += 2
                else:
                    out.append(s[i])
                    i += 1
            new[tuple(out)] = new.get(tuple(out), 0) + c
        seqs = new
    return merges


def write_clip_tokenizer(path, pad_token="<|endoftext|>", vocab_size=49408, n_merges=300):
    """vocab.json / merges.txt in CLIP's layout (256 bytes, 256 bytes + </w>,
    the merges, fillers, <|startoftext|> and <|endoftext|> last), saved
    through transformers' CLIPTokenizer with the given pad token."""
    from transformers import CLIPTokenizer

    os.makedirs(path, exist_ok=True)
    merges = _train_bpe((CORPUS + " " + " ".join(PROMPTS[:6])).lower().split(), n_merges)
    chars = list(ttok.bytes_to_unicode().values())
    vocab = chars + [c + "</w>" for c in chars] + ["".join(m) for m in merges]
    vocab = list(dict.fromkeys(vocab))
    vocab += [f"<filler_{i}>" for i in range(vocab_size - 2 - len(vocab))]
    vocab += ["<|startoftext|>", "<|endoftext|>"]
    tmp = os.path.join(path, "_src")
    os.makedirs(tmp, exist_ok=True)
    with open(os.path.join(tmp, "vocab.json"), "w") as f:
        json.dump({t: i for i, t in enumerate(vocab)}, f)
    with open(os.path.join(tmp, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "\n".join(" ".join(m) for m in merges) + "\n")
    tok = CLIPTokenizer(os.path.join(tmp, "vocab.json"), os.path.join(tmp, "merges.txt"),
                        pad_token=pad_token)
    tok.save_pretrained(path)
    return path


@pytest.fixture(scope="module", params=["<|endoftext|>", "!"], ids=["pad-eot", "pad-bang"])
def clip_dir(request, tmp_path_factory):
    return write_clip_tokenizer(str(tmp_path_factory.mktemp("clip_tok")), request.param)


def test_clip_tokenizer_ids_bit_exact(clip_dir):
    from transformers import CLIPTokenizer

    want = CLIPTokenizer.from_pretrained(clip_dir)
    assert want.fix_text is None  # the no-ftfy branch, as on the card's machine
    got = ttok.load_tokenizer(clip_dir)
    assert isinstance(got, ttok.CLIPTokenizer) and got.pad_id == want.pad_token_id
    ref = want(PROMPTS, padding="max_length", max_length=77, truncation=True,
               return_tensors="np")
    ids, mask = got(PROMPTS, 77)
    np.testing.assert_array_equal(ids, ref.input_ids)
    np.testing.assert_array_equal(mask, ref.attention_mask)
    assert mask[-1].all()  # the long prompts fill all 77


def test_clip_split_classifies_by_unicode_category():
    """½ and ² are numbers (\\p{N}), one a match; letters run together."""
    assert ttok.clip_split("x½²ab12") == ["x", "½", "²", "ab", "1", "2"]
    assert ttok.clip_split("it's <|endoftext|>!!") == ["it", "'s", "<|endoftext|>", "!!"]


# ------------------------------------------------------- Precompiled charsmap


CHARSMAP = {"Ａ": "A", "Ｂ": "B", "ａ": "a", "…": "...", " ": " ", "ﬁ": "fi",
            "é": "é", "①": "1", "　": " ", "Ｂ́": "Q", "½": "1⁄2"}


@pytest.mark.parametrize("text", ["ＡＢａ…xﬁ y", "café Ａ́ Ｂ́", "a　b",
                                  "Ａ́́́", "é́", "A‍Ａ", "",
                                  "\r\n①½ plain", "각ＡＢ", "x\U0001F1E6\U0001F1E7Ａ"])
def test_precompiled_charsmap_matches_tokenizers(text):
    from tokenizers import normalizers

    blob = ttok.build_precompiled_charsmap(CHARSMAP)
    assert ttok.PrecompiledCharsmap(blob)(text) == normalizers.Precompiled(blob).normalize_str(text)


# ------------------------------------------------------- T5 / UMT5 Unigram


def _unigram_vocab(seed: int, n: int):
    """<pad>, </s>, <unk>, then ▁ + words, their prefixes and substrings of
    the corpus, scores drawn from a seed; every ASCII letter and digit but
    'q', 'z' and '9' (left unknown) is a piece."""
    rng = np.random.default_rng(seed)
    words = (CORPUS + " photo cat hat tag user full width ellipsis nbsp fine mixed zero "
             "width nul bell spaces and tab newline end literal eos here hello wow").split()
    pieces = {"▁"}
    for w in words:
        pieces.add("▁" + w)
        for i in range(len(w)):
            for j in range(i + 1, min(len(w), i + 4) + 1):
                pieces.add(w[i:j])
    for c in "abcdefghijklmnoprstuvwxy012345678ABCDEFGHIJKLMNOPRSTUVWXY.,!?;:'()-#@$%½²":
        pieces.add(c)
    pieces = sorted(pieces)[:n]
    scores = -rng.uniform(2.0, 14.0, len(pieces))
    return [("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0)] + list(zip(pieces,
                                                                     scores.tolist()))


def write_t5_tokenizer(path, umt5: bool = False, scheme: str = "always", n: int = 600,
                       seed: int = 0):
    """A Unigram tokenizer.json as T5TokenizerFast saves it (UMT5's through
    AutoTokenizer): Sequence[Precompiled, Replace(" {2,}", " ")] (UMT5:
    Strip and NFKC around them), Metaspace, TemplateProcessing "$A </s>"."""
    from tokenizers import AddedToken, Regex, Tokenizer, models, normalizers, pre_tokenizers, \
        processors
    from transformers import T5TokenizerFast

    tok = Tokenizer(models.Unigram(_unigram_vocab(seed, n), unk_id=2, byte_fallback=False))
    norms = [normalizers.Precompiled(ttok.build_precompiled_charsmap(CHARSMAP)),
             normalizers.Replace(Regex(" {2,}"), " ")]
    if umt5:
        norms = [normalizers.Strip(left=False, right=True)] + norms + [normalizers.NFKC()]
    tok.normalizer = normalizers.Sequence(norms)
    tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme=scheme)
    tok.post_processor = processors.TemplateProcessing(
        single="$A </s>", pair="$A </s> $B </s>", special_tokens=[("</s>", 1)])
    fast = T5TokenizerFast(tokenizer_object=tok, eos_token="</s>", unk_token="<unk>",
                           pad_token="<pad>", extra_ids=0 if umt5 else 8)
    if scheme == "first":  # added tokens matched after normalization, eating spaces
        fast.add_tokens([AddedToken("<sep>", lstrip=True, rstrip=True, normalized=True),
                         AddedToken("ＳＥＰ", normalized=False)])
    fast.save_pretrained(path)
    return path


T5_CASES = [("t5", False, "always"), ("t5-first", False, "first"), ("umt5", True, "always")]


@pytest.mark.parametrize("name,umt5,scheme", T5_CASES)
def test_unigram_tokenizer_ids_bit_exact(tmp_path, name, umt5, scheme):
    from transformers import AutoTokenizer, T5TokenizerFast

    path = write_t5_tokenizer(str(tmp_path / name), umt5, scheme)
    want = (AutoTokenizer if umt5 else T5TokenizerFast).from_pretrained(path)
    got = ttok.load_tokenizer(path)
    assert isinstance(got, ttok.UnigramTokenizer)
    for max_length in (77, 512):
        ref = want(PROMPTS, padding="max_length", max_length=max_length, truncation=True,
                   return_tensors="np")
        ids, mask = got(PROMPTS, max_length)
        for i, p in enumerate(PROMPTS):
            assert ids[i].tolist() == ref.input_ids[i].tolist(), (max_length, p)
        np.testing.assert_array_equal(mask, ref.attention_mask)
    assert got.model.unk_id in ids[3].tolist()  # CJK: unknown characters, fused
    assert mask[-1].all()  # the longest prompt passes 512 tokens


# ------------------------------------------------------------------ modules


def _clip_hf(seed: int, eos_token_id: int, act: str, projection: bool, vocab: int = 49408):
    from transformers import CLIPTextConfig, CLIPTextModel, CLIPTextModelWithProjection

    torch.manual_seed(seed)
    cfg = CLIPTextConfig(vocab_size=vocab, hidden_size=32, intermediate_size=64,
                         num_hidden_layers=3, num_attention_heads=4, max_position_embeddings=77,
                         hidden_act=act, eos_token_id=eos_token_id, projection_dim=24)
    cls = CLIPTextModelWithProjection if projection else CLIPTextModel
    return cls(cfg).eval()


CLIP_CASES = [(2, "quick_gelu", False), (49407, "gelu", True), (2, "gelu", True),
              (49407, "quick_gelu", False)]


@pytest.mark.parametrize("eos,act,projection", CLIP_CASES)
def test_clip_text_model_matches_transformers(tmp_path, clip_dir, eos, act, projection):
    """The port's CLIP text tower loaded from save_pretrained's directory,
    on ids from the tokenizer (padded with <|endoftext|> or "!"): the last
    state, pooled token, hidden_states[-2] and projection within relative
    L2 1e-5 of transformers' in f32."""
    from fastdm_tpu_torch.models import clip_text as tclip
    from fastdm_tpu_torch.models.loader import TensorSource

    from safetensors.torch import load_file, save_file

    hf = _clip_hf(3, eos, act, projection)
    hf.save_pretrained(str(tmp_path / "te"))
    if eos == 2:  # older checkpoints keep the position ids buffer; it stays unread
        st = str(tmp_path / "te" / "model.safetensors")
        sd = load_file(st)
        sd["text_model.embeddings.position_ids"] = torch.arange(77)[None]
        save_file(sd, st)
    cfg = tclip.CLIPTextConfig.from_dir(str(tmp_path / "te"))
    assert (cfg.eos_token_id, cfg.hidden_act, cfg.num_hidden_layers) == (eos, act, 3)
    model = tclip.clip_text_load(TensorSource.from_path(str(tmp_path / "te"), "cpu"), cfg,
                                 projection)
    ids, _ = ttok.load_tokenizer(clip_dir)(PROMPTS[:4] + PROMPTS[-1:], 77)
    ids = torch.from_numpy(ids)
    with torch.no_grad():
        want = hf(ids, output_hidden_states=True)
        got = model(ids)
        pooled = hf.text_model(ids).pooler_output
    pairs = [(got.last_hidden_state, want.last_hidden_state),
             (got.penultimate, want.hidden_states[-2]), (got.pooler_output, pooled)]
    if projection:
        pairs.append((got.text_embeds, want.text_embeds))
    else:
        assert got.text_embeds is None
    for a, b in pairs:
        assert a.shape == b.shape and a.dtype == torch.float32
        assert _rel_l2(a, b) <= 1e-5


def _t5_hf(seed: int, umt5: bool, vocab: int):
    from transformers import T5Config, T5EncoderModel, UMT5Config, UMT5EncoderModel

    torch.manual_seed(seed)
    kw = dict(vocab_size=vocab, d_model=32, d_kv=8, d_ff=48, num_layers=3, num_heads=4,
              feed_forward_proj="gated-gelu", relative_attention_num_buckets=32,
              relative_attention_max_distance=128, dropout_rate=0.0)
    model = (UMT5EncoderModel(UMT5Config(**kw)) if umt5 else T5EncoderModel(T5Config(**kw)))
    with torch.no_grad():  # relative biases and norms away from their init
        for name, p in model.named_parameters():
            if "relative_attention_bias" in name or "layer_norm" in name:
                p.add_(torch.randn_like(p))
    return model.eval()


@pytest.mark.parametrize("umt5,masked,sharded", [(False, False, True), (False, True, False),
                                                 (True, True, True), (True, False, False)])
def test_t5_encoder_matches_transformers(tmp_path, umt5, masked, sharded):
    """T5EncoderModel / UMT5EncoderModel from save_pretrained's directory
    (sharded: the shards globbed), on the tokenizer's ids at 300 tokens
    (relative positions past the 128 max distance), with and without the
    padding mask: the last state within relative L2 1e-5 in f32. Unsharded,
    the T5 embedding is renamed to encoder.embed_tokens.weight and UMT5's
    stored under both names."""
    from safetensors.torch import load_file, save_file

    from fastdm_tpu_torch.models import t5 as tt5
    from fastdm_tpu_torch.models.loader import TensorSource

    tok = ttok.load_tokenizer(write_t5_tokenizer(str(tmp_path / "tok"), umt5))
    hf = _t5_hf(5, umt5, 640)
    te = str(tmp_path / "te")
    hf.save_pretrained(te, max_shard_size="40KB" if sharded else "10GB")
    files = sorted(f for f in os.listdir(te) if f.endswith(".safetensors"))
    assert len(files) > 1 if sharded else files == ["model.safetensors"]
    if not sharded:  # T5: the embedding under its other name; UMT5: under both
        sd = load_file(os.path.join(te, "model.safetensors"))
        sd["encoder.embed_tokens.weight"] = (sd["shared.weight"].clone() if umt5
                                             else sd.pop("shared.weight"))
        save_file(sd, os.path.join(te, "model.safetensors"))
    cfg = tt5.T5Config.from_dir(te)
    assert cfg.umt5 == umt5 and cfg.num_layers == 3
    model = tt5.t5_encoder_load(TensorSource.from_path(te, "cpu"), cfg)
    ids, mask = tok(PROMPTS[:3] + PROMPTS[-2:], 300)
    ids, mask = torch.from_numpy(ids), torch.from_numpy(mask)
    with torch.no_grad():
        want = hf(ids, attention_mask=mask if masked else None)[0]
        got = model(ids, mask if masked else None)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel_l2(got, want) <= 1e-5


def test_relative_buckets_match_transformers():
    from transformers.models.t5.modeling_t5 import T5Attention, T5Config

    from fastdm_tpu_torch.models.t5 import relative_position_buckets

    att = T5Attention(T5Config(), has_relative_attention_bias=True)
    rel = torch.arange(600)[None, :] - torch.arange(600)[:, None]
    want = att._relative_position_bucket(rel, bidirectional=True, num_buckets=32,
                                         max_distance=128)
    assert torch.equal(relative_position_buckets(600, 32, 128), want)


# ------------------------------------------- the port's writers (smoke runs)


def test_written_tokenizers_read_by_transformers(tmp_path):
    """save_clip_tokenizer / save_unigram_tokenizer (the files chip_smoke.py
    writes) load in transformers and give the ids the port's readers give."""
    from transformers import AutoTokenizer, CLIPTokenizer, T5TokenizerFast

    src = write_clip_tokenizer(str(tmp_path / "src"))
    vocab = json.load(open(os.path.join(src, "vocab.json")))
    merges = [tuple(m.split()) for m in open(os.path.join(src, "merges.txt")).read()
              .strip().split("\n")[1:]]
    ttok.save_clip_tokenizer(str(tmp_path / "clip"), vocab, merges, pad_token="!")
    ttok.save_unigram_tokenizer(str(tmp_path / "t5"), _unigram_vocab(4, 700), CHARSMAP)
    for path, ref, n in ((tmp_path / "clip", CLIPTokenizer, 77),
                         (tmp_path / "t5", T5TokenizerFast, 300),
                         (tmp_path / "t5", AutoTokenizer, 512)):
        want = ref.from_pretrained(str(path))(PROMPTS, padding="max_length", max_length=n,
                                             truncation=True, return_tensors="np")
        ids, mask = ttok.load_tokenizer(str(path))(PROMPTS, n)
        np.testing.assert_array_equal(ids, want.input_ids)
        np.testing.assert_array_equal(mask, want.attention_mask)


@pytest.mark.parametrize("kind", ["clip", "clip-proj", "t5", "umt5"])
def test_written_encoders_read_by_transformers(tmp_path, kind):
    """*_init_random + save_text_encoder (in f32 here) load in transformers'
    classes, whose outputs match the port's within relative L2 1e-5."""
    from transformers import (CLIPTextModel, CLIPTextModelWithProjection, T5EncoderModel,
                              UMT5EncoderModel)

    from fastdm_tpu_torch.models import clip_text as tclip
    from fastdm_tpu_torch.models import t5 as tt5
    from fastdm_tpu_torch.pipeline.text_encoder import save_text_encoder

    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 500, (2, 77)))
    path = str(tmp_path / kind)
    if kind.startswith("clip"):
        proj = kind == "clip-proj"
        cfg = tclip.CLIPTextConfig(vocab_size=512, hidden_size=32, intermediate_size=48,
                                   num_hidden_layers=2, num_attention_heads=2,
                                   hidden_act="gelu" if proj else "quick_gelu",
                                   eos_token_id=2 if proj else 511, projection_dim=16)
        model = tclip.clip_text_init_random(7, cfg, proj, "cpu")
        save_text_encoder(model, path, torch.float32)
        hf = (CLIPTextModelWithProjection if proj else CLIPTextModel).from_pretrained(path)
        with torch.no_grad():
            got, want = model(ids), hf(ids, output_hidden_states=True)
        pairs = [(got.last_hidden_state, want.last_hidden_state),
                 (got.penultimate, want.hidden_states[-2])]
        if proj:
            pairs.append((got.text_embeds, want.text_embeds))
    else:
        cfg = tt5.T5Config(vocab_size=512, d_model=32, d_kv=8, d_ff=48, num_layers=2,
                           num_heads=4, umt5=kind == "umt5")
        model = tt5.t5_encoder_init_random(7, cfg, "cpu")
        save_text_encoder(model, path, torch.float32)
        hf = (UMT5EncoderModel if cfg.umt5 else T5EncoderModel).from_pretrained(path)
        mask = torch.ones_like(ids)
        mask[1, 40:] = 0
        with torch.no_grad():
            pairs = [(model(ids, mask), hf(ids, attention_mask=mask)[0])]
    for a, b in pairs:
        assert _rel_l2(a, b) <= 1e-5


# ------------------------------------- encoder directories of tiny checkpoints


def _save_clip_model(path, seed, hidden, projection, proj_dim=None, act="quick_gelu",
                     eos=2):
    from transformers import CLIPTextConfig, CLIPTextModel, CLIPTextModelWithProjection

    torch.manual_seed(seed)
    cfg = CLIPTextConfig(vocab_size=49408, hidden_size=hidden, intermediate_size=2 * hidden,
                         num_hidden_layers=2, num_attention_heads=2, max_position_embeddings=77,
                         hidden_act=act, eos_token_id=eos, projection_dim=proj_dim or hidden)
    (CLIPTextModelWithProjection if projection else CLIPTextModel)(cfg).save_pretrained(path)


@lru_cache(maxsize=2)
def _clip_tokenizer_once(pad: str) -> str:
    return write_clip_tokenizer(tempfile.mkdtemp(prefix="clip-tok-"), pad)


def write_text_dirs(root: str, family: str, dims: dict) -> None:
    """The tokenizer*/ and text_encoder*/ directories of a family, written by
    transformers (its save_pretrained) at tiny widths: flux (CLIP-L hidden
    dims["pooled"], T5 dims["t5"]), sdxl (CLIP-L dims["l"], bigG dims["g"]
    with projection dims["g_proj"], pad "!"), sd35 (both CLIPs with
    projections, T5), wan (UMT5 dims["t5"])."""
    def clip_tok(name, pad):
        shutil.copytree(_clip_tokenizer_once(pad), os.path.join(root, name))

    def t5(tok, enc, seed, umt5=False):
        from transformers import T5Config, T5EncoderModel, UMT5Config, UMT5EncoderModel

        write_t5_tokenizer(os.path.join(root, tok), umt5, seed=seed)

        torch.manual_seed(seed)
        kw = dict(vocab_size=640, d_model=dims["t5"], d_kv=8, d_ff=2 * dims["t5"], num_layers=2,
                  num_heads=4, feed_forward_proj="gated-gelu", dropout_rate=0.0)
        model = UMT5EncoderModel(UMT5Config(**kw)) if umt5 else T5EncoderModel(T5Config(**kw))
        with torch.no_grad():
            for name, p in model.named_parameters():
                if "relative_attention_bias" in name or "layer_norm" in name:
                    p.add_(torch.randn_like(p))
        model.save_pretrained(os.path.join(root, enc))

    if family == "flux":
        clip_tok("tokenizer", "<|endoftext|>")
        _save_clip_model(os.path.join(root, "text_encoder"), 21, dims["pooled"], False)
        t5("tokenizer_2", "text_encoder_2", 22)
    elif family == "sdxl":
        clip_tok("tokenizer", "<|endoftext|>")
        _save_clip_model(os.path.join(root, "text_encoder"), 23, dims["l"], False)
        clip_tok("tokenizer_2", "!")
        _save_clip_model(os.path.join(root, "text_encoder_2"), 24, dims["g"], True,
                         dims["g_proj"], "gelu", 49407)
    elif family == "sd35":
        clip_tok("tokenizer", "<|endoftext|>")
        _save_clip_model(os.path.join(root, "text_encoder"), 25, dims["l"], True, dims["l_proj"])
        clip_tok("tokenizer_2", "!")
        _save_clip_model(os.path.join(root, "text_encoder_2"), 26, dims["g"], True,
                         dims["g_proj"], "gelu", 49407)
        t5("tokenizer_3", "text_encoder_3", 27)
    else:
        t5("tokenizer", "text_encoder", 28, umt5=True)
