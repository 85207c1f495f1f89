"""The port's tokenizer (gemma_tpu_torch/models/tokenizer.py: its own
reader of the SentencePiece proto) against the JAX package's
GemmaTokenizer, which on this host (no `sentencepiece`) runs transformers'
GemmaConverter and HF `tokenizers`: encode, decode and id_to_piece equal on
tests/test_tokenizer.py:tiny_proto, on a BPE-typed variant of it, on a
hypothesis corpus and on chip_smoke.py's 256000-piece proto; the chat
template for every wrapping; chip_smoke.py's proto writer."""

import importlib
import importlib.util
from pathlib import Path

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from gemma_tpu.models import tokenizer as jtok
from gemma_tpu.models.configs import PromptWrapping as JWrapping
from gemma_tpu_torch.models import tokenizer as ttok
from gemma_tpu_torch.models.configs import PromptWrapping as TWrapping
from tests.test_tokenizer import tiny_proto

ROOT = Path(__file__).resolve().parent.parent
CONTROL = ["<pad>", "<eos>", "<bos>", "<unk>", "<start_of_turn>",
           "<end_of_turn>", "<start_of_image>", "<end_of_image>"]

# (text, ids) as the JAX package gives them here.
PROBES = [
    ("<start_of_turn>user\n", [4, 272, 271]),
    ("a<end_of_turn>b", [105, 5, 106]),
    ("café", [107, 105, 110, 203, 177]),
    ("hello world", [268, 265]),
    (" hello  world ", [264, 270, 265, 270]),
    ("", []),
    ("<unk>", [3]),
    ("<unk>x", [68, 125, 118, 115, 70, 128]),
    ("hello<unk>", [268, 3]),
    ("a<0x41>", [105, 73]),
    ("\t", [17]),
    ("日本", [238, 159, 173, 238, 164, 180]),
]


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bpe_proto() -> bytes:
    """tiny_proto with model_type BPE, built the same way, plus single
    letters and merged pieces so that merges apply."""
    from transformers.convert_slow_tokenizer import import_protobuf

    pb = import_protobuf()
    m = pb.ModelProto()
    m.ParseFromString(tiny_proto())
    m.trainer_spec.model_type = pb.TrainerSpec.BPE
    extra = list("helowrdusm") + ["he", "ll", "hell", "lo", "wo", "rl",
                                  "rld", "▁h", "▁w", "el", "ell"]
    for i, w in enumerate(extra):
        p = m.pieces.add()
        p.piece = w
        p.score = -11.0 - i % 5
    return m.SerializeToString()


@pytest.fixture(scope="module")
def jax_bpe_extractor():
    """GemmaConverter reads BPE merges through sentencepiece, which this
    host lacks: give its extractor the proto's pieces instead (what
    sentencepiece's id_to_piece returns), so the JAX package's HF path
    builds the BPE model it would build."""
    from transformers.convert_slow_tokenizer import import_protobuf

    conv = importlib.import_module("transformers.convert_slow_tokenizer")
    pb = import_protobuf()

    class Pieces:
        def __init__(self, path):
            m = pb.ModelProto()
            with open(path, "rb") as f:
                m.ParseFromString(f.read())
            self.pieces = [p.piece for p in m.pieces]

        def id_to_piece(self, i):
            return self.pieces[i]

        def GetPieceSize(self):
            return len(self.pieces)

    class Extractor(conv.GemmaSentencePieceExtractor):
        def __init__(self, model):
            self.sp = Pieces(model)

    old = conv.GemmaConverter.SpmExtractor
    conv.GemmaConverter.SpmExtractor = Extractor
    yield
    conv.GemmaConverter.SpmExtractor = old


@pytest.fixture(scope="module")
def pairs(jax_bpe_extractor):
    bpe = _bpe_proto()
    return {"unigram": (jtok.GemmaTokenizer(tiny_proto()),
                        ttok.GemmaTokenizer(tiny_proto())),
            "bpe": (jtok.GemmaTokenizer(bpe), ttok.GemmaTokenizer(bpe))}


def test_the_port_reads_the_proto_itself():
    tok = ttok.GemmaTokenizer(tiny_proto())
    assert tok.available and tok._reader is not None
    assert tok.serialize() == tiny_proto()
    model = tok._reader.model
    assert len(model.pieces) == model.vocab_size == 274
    assert model.pieces[4] == ("<start_of_turn>", 0.0, ttok.CONTROL)
    assert model.pieces[264] == ("▁hello", -1.0, ttok.NORMAL)
    assert (model.model_type, model.byte_fallback, model.unk_id) == \
        (ttok.UNIGRAM, True, 3)
    assert (model.add_dummy_prefix, model.remove_extra_whitespaces,
            model.escape_whitespaces) == (False, True, True)
    with pytest.raises(ValueError):
        ttok.parse_model_proto(b"\x0a\xff")


def test_mock_tokenizer():
    tok = ttok.GemmaTokenizer(ttok.MOCK_TOKENIZER)
    assert not tok.available
    assert tok.encode("hi") == [] and tok.decode([5]) == ""
    assert tok.serialize() == ttok.MOCK_TOKENIZER == jtok.MOCK_TOKENIZER
    assert ttok.GemmaTokenizer(None).serialize() == ttok.MOCK_TOKENIZER
    assert ttok.BOS_ID == jtok.BOS_ID


@pytest.mark.parametrize("text,ids", PROBES)
def test_probes(pairs, text, ids):
    jt, tt = pairs["unigram"]
    assert jt.encode(text) == ids
    assert tt.encode(text) == ids
    assert tt.decode(ids) == jt.decode(ids)
    if "<0x" not in text:
        assert tt.decode(ids) == text


@pytest.mark.parametrize("ids,text", [
    ([203], "�"),
    ([5000, 268, 100000, 1], "hello<eos>"),
    ([203, 5, 177], "�<end_of_turn>�"),
    ([203, 203, 177], "���"),
    ([105, 2, 270, 271], "a<bos> \n"),
    ([264, 203, 177, 265], " helloé world"),
])
def test_decode_probes(pairs, ids, text):
    jt, tt = pairs["unigram"]
    assert jt.decode(ids) == tt.decode(ids) == text


def test_id_to_piece(pairs):
    for jt, tt in pairs.values():
        n = len(tt._reader.model.pieces)
        for i in range(n + 3):
            assert tt.id_to_piece(i) == jt.id_to_piece(i), i
        assert tt.id_to_piece(5000) == "" and tt.id_to_piece(-1) == ""
    assert pairs["unigram"][1].id_to_piece(17) == "\t"


_corpus = st.lists(st.one_of(
    st.text(alphabet="abcdehlmnorsuwz .,!?", max_size=12),
    st.text(alphabet="àéîõüçñßÅ", max_size=4),
    st.text(alphabet="日本語中文字漢한국", max_size=4),
    st.text(alphabet="😀🎉🚀👍", max_size=3),
    st.sampled_from([" ", "  ", "   ", "\t", "\n", "\n\n", " \n ", "▁"]),
    st.sampled_from(CONTROL + ["<start_of", "of_turn>", "<0x41>", "<0xZZ>"]),
    st.text(st.characters(blacklist_categories=("Cs",)), max_size=6),
), max_size=10).map("".join)


@settings(max_examples=150, deadline=None)
@given(text=_corpus)
def test_corpus_unigram(pairs, text):
    jt, tt = pairs["unigram"]
    ids = jt.encode(text)
    assert tt.encode(text) == ids
    assert tt.decode(ids) == jt.decode(ids)


@settings(max_examples=150, deadline=None)
@given(text=_corpus)
def test_corpus_bpe(pairs, text):
    jt, tt = pairs["bpe"]
    ids = jt.encode(text)
    assert tt.encode(text) == ids
    assert tt.decode(ids) == jt.decode(ids)


@settings(max_examples=100, deadline=None)
@given(ids=st.lists(st.integers(0, 400), max_size=12))
def test_decode_any_ids(pairs, ids):
    for jt, tt in pairs.values():
        assert tt.decode(ids) == jt.decode(ids)


@pytest.mark.parametrize("wrapping", list(TWrapping))
def test_chat_template_and_wrapping(pairs, wrapping):
    jt, tt = pairs["unigram"]
    jw = JWrapping(int(wrapping))
    jtpl, ttpl = jtok.ChatTemplate(jt), ttok.ChatTemplate(tt)
    for name in ("sot_user", "sot_model", "eot", "pali_sep", "vlm_soi",
                 "vlm_eoi"):
        assert getattr(ttpl, name) == getattr(jtpl, name), name
    assert ttpl.apply(0, [268]) == jtpl.apply(0, [268])
    assert ttpl.apply(9, [268]) == jtpl.apply(9, [268])
    for pos in (0, 7):
        for prompt in ("hello world", "café <end_of_turn>", ""):
            assert ttok.wrap_and_tokenize(tt, ttpl, wrapping, pos, prompt) \
                == jtok.wrap_and_tokenize(jt, jtpl, jw, pos, prompt)
    for n_img in (2, 5):
        pos = 0 if wrapping == TWrapping.PALIGEMMA else 3
        try:
            want = jtok.wrap_and_tokenize(jt, jtpl, jw, pos, "hello",
                                          image_batch_size=n_img)
        except ValueError:
            with pytest.raises(ValueError):
                ttok.wrap_and_tokenize(tt, ttpl, wrapping, pos, "hello",
                                       image_batch_size=n_img)
            continue
        assert ttok.wrap_and_tokenize(tt, ttpl, wrapping, pos, "hello",
                                      image_batch_size=n_img) == want


def test_chip_smoke_proto_writer():
    """chip_smoke.py writes tiny_proto's bytes for its layout, and
    importing it runs nothing."""
    cs = _load_chip_smoke()
    words = ["▁hello", "▁world", "▁user", "▁model", "hello", "world", "▁",
             "\n", "user", "model"]
    pieces = [(p, 0.0, kind) for p, kind in cs.SPM_CONTROL_PIECES]
    pieces += [(f"<0x{b:02X}>", 0.0, cs.SPM_BYTE) for b in range(256)]
    pieces += [(w, -float(i + 1), cs.SPM_NORMAL) for i, w in enumerate(words)]
    assert cs.spm_model_proto(pieces) == tiny_proto()


def test_full_vocab_proto_matches_jax():
    """chip_smoke.py's 256000-piece proto: the port's encoding equals the
    JAX package's, and every id decodes."""
    cs = _load_chip_smoke()
    proto = cs.spm_model_proto(cs.gemma_layout_pieces(256000))
    jt, tt = jtok.GemmaTokenizer(proto), ttok.GemmaTokenizer(proto)
    assert len(tt._reader.model.pieces) == 256000
    for text in ("The quick brown fox jumps over the lazy dog.",
                 "<start_of_turn>user\nWrite a poem about café life, "
                 "日本.<end_of_turn>\n<start_of_turn>model\n",
                 "  indented\n\tcode = x + 1  # 😀"):
        ids = jt.encode(text)
        assert tt.encode(text) == ids
        assert tt.decode(ids) == jt.decode(ids) == text
    some = list(range(0, 256000, 997)) + [255999]
    assert tt.decode(some) == jt.decode(some)
    assert all(tt.id_to_piece(i) for i in some)
