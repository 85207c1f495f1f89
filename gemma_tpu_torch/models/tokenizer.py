"""Tokenizer + chat template (counterpart of gemma_tpu/models/tokenizer.py;
reference gemma/tokenizer.{h,cc}).

The reference wraps SentencePiece and stores the serialized model proto as
a blob inside the weights file (gemma/tokenizer.cc:39-47, model_store).
Here the proto is loaded through one of, in the JAX package's order:

  1. `sentencepiece` (bit-exact with the reference, if installed),
  2. the port's own reader (`SpmReader`): the proto parsed from its wire
     format with the stdlib, and encoded and decoded as transformers'
     GemmaConverter + HF `tokenizers` do it, which is what the JAX
     package runs on a host without `sentencepiece`.  The port imports
     neither, so the same text gives the same ids on any host without
     `sentencepiece`, the CUDA machines included;
  3. the `kMockTokenizer` placeholder used by tests (gemma/tokenizer.h:34).

What the reader reproduces (GemmaConverter, transformers 4.57):
  - the vocabulary: the proto's pieces and scores, the first three named
    <pad>, <eos>, <bos> with score 0, and the byte piece <0x09> renamed
    "\\t" (score 0) when the proto has no tab piece;
  - CONTROL and USER_DEFINED pieces are matched whole in the raw text,
    leftmost-longest, before anything else;
  - the rest of the text gets " " -> "▁" and one model pass: `UNIGRAM`
    protos a Viterbi over the piece scores in which a character no piece
    starts gets the unknown score (lowest piece score - 10), runs of
    unknown nodes fuse, and a fused run that is no piece falls back to
    its UTF-8 byte pieces; `BPE` protos split into characters (byte
    pieces for the missing ones) and merge by the ranks GemmaConverter
    derives from the piece scores;
  - decoding maps ids to pieces (out-of-vocab ids are dropped), "▁" to
    " ", fuses each run of byte pieces into UTF-8 (a run that is not
    valid UTF-8 gives one U+FFFD per byte) and joins.
The normalizer fields of the proto are read but, as in the converter,
not used: the Gemma conversion fixes its own normalizer.  With
`sentencepiece` installed both packages use it, and control pieces in
the text are then split like any other text (ROADMAP.md §3).

Chat template semantics are mirrored from GemmaChatTemplate
(gemma/tokenizer.cc:108-173): BOS or <end_of_turn> continuation prefix,
<start_of_turn>user/model turns, PaliGemma image-slot prefixes, Gemma3 VLM
<start_of_image> blocks of -2 placeholders.
"""

from __future__ import annotations

import dataclasses
import heapq
import re
import struct
from typing import Sequence

from gemma_tpu_torch.models.configs import PromptWrapping

BOS_ID = 2  # gemma/tokenizer.h:29
MOCK_TOKENIZER = b"unavailable"  # gemma/tokenizer.h:34

# sentencepiece_model.proto: SentencePiece.Type, TrainerSpec.ModelType
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6
UNIGRAM, BPE = 1, 2
SPACE = "▁"
UNK_PENALTY = 10.0  # tokenizers' unigram K_UNK_PENALTY


@dataclasses.dataclass
class SpmModel:
    """The fields of a SentencePiece ModelProto that the Gemma conversion
    reads, with the proto's defaults."""

    pieces: list  # [(piece, score, type)]
    model_type: int = UNIGRAM
    vocab_size: int = 8000
    byte_fallback: bool = False
    unk_id: int = 0
    unk_piece: str = "<unk>"
    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = True
    escape_whitespaces: bool = True


def _varint(buf: bytes, i: int) -> tuple[int, int]:
    value = shift = 0
    while True:
        b = buf[i]
        i += 1
        value |= (b & 0x7F) << shift
        if b < 0x80:
            return value, i
        shift += 7


def _fields(buf: bytes):
    """(field number, wire type, value) of one message: an int for VARINT,
    I64 and I32 fields (raw bits), bytes for LEN fields."""
    i, n = 0, len(buf)
    while i < n:
        key, i = _varint(buf, i)
        num, wt = key >> 3, key & 7
        if wt == 0:
            value, i = _varint(buf, i)
        elif wt == 2:
            size, i = _varint(buf, i)
            value, i = buf[i:i + size], i + size
        elif wt == 5:
            value, i = int.from_bytes(buf[i:i + 4], "little"), i + 4
        elif wt == 1:
            value, i = int.from_bytes(buf[i:i + 8], "little"), i + 8
        else:
            raise ValueError(f"unsupported protobuf wire type {wt}")
        if i > n:
            raise ValueError("truncated protobuf message")
        yield num, wt, value


def _int32(v: int) -> int:
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >> 63 else v


def parse_model_proto(proto: bytes) -> SpmModel:
    """SpmModel from a serialized sentencepiece ModelProto (wire format)."""
    model = SpmModel(pieces=[])
    unpack_f32 = struct.Struct("<f").unpack
    try:
        for num, wt, value in _fields(proto):
            if num == 1 and wt == 2:
                piece, score, kind = "", 0.0, NORMAL
                for pn, pw, pv in _fields(value):
                    if pn == 1 and pw == 2:
                        piece = pv.decode("utf-8")
                    elif pn == 2 and pw == 5:
                        score = unpack_f32(pv.to_bytes(4, "little"))[0]
                    elif pn == 3 and pw == 0:
                        kind = pv
                model.pieces.append((piece, score, kind))
            elif num == 2 and wt == 2:
                for tn, tw, tv in _fields(value):
                    if tw == 0 and tn == 3:
                        model.model_type = tv
                    elif tw == 0 and tn == 4:
                        model.vocab_size = _int32(tv)
                    elif tw == 0 and tn == 35:
                        model.byte_fallback = bool(tv)
                    elif tw == 0 and tn == 40:
                        model.unk_id = _int32(tv)
                    elif tw == 2 and tn == 45:
                        model.unk_piece = tv.decode("utf-8")
            elif num == 3 and wt == 2:
                for nn, nw, nv in _fields(value):
                    if nw == 0 and nn == 3:
                        model.add_dummy_prefix = bool(nv)
                    elif nw == 0 and nn == 4:
                        model.remove_extra_whitespaces = bool(nv)
                    elif nw == 0 and nn == 5:
                        model.escape_whitespaces = bool(nv)
    except (IndexError, UnicodeDecodeError) as e:
        raise ValueError(f"not a sentencepiece model proto: {e}") from e
    return model


def _byte_of(token: str) -> int | None:
    """The byte a piece "<0xXX>" stands for (tokenizers' ByteFallback
    decoder: six bytes, a radix-16 u8 between "<0x" and ">")."""
    if len(token.encode("utf-8")) != 6 or not token.startswith("<0x") \
            or not token.endswith(">"):
        return None
    digits = token[3:5]
    if re.fullmatch(r"\+?[0-9A-Fa-f]+", digits) is None:
        return None
    return int(digits, 16)


class SpmReader:
    """Encode / decode over a parsed ModelProto as GemmaConverter builds it
    (module docstring)."""

    def __init__(self, model: SpmModel):
        if model.model_type not in (UNIGRAM, BPE):
            raise ValueError(f"sentencepiece model_type {model.model_type}: "
                             "only UNIGRAM (1) and BPE (2) convert")
        vocab = [(p, s) for p, s, _ in model.pieces]
        vocab[:3] = [("<pad>", 0.0), ("<eos>", 0.0), ("<bos>", 0.0)]
        if not any(p == "\t" for p, _ in vocab):
            tab = next((i for i, (p, _) in enumerate(vocab)
                        if p == "<0x09>"), None)
            if tab is not None:
                vocab[tab] = ("\t", 0.0)
        self.model = model
        self._pieces = [p for p, _ in vocab]
        self._scores = [float(s) for _, s in vocab]
        self._ids = {p: i for i, p in enumerate(self._pieces)}
        self._max_len = max((len(p) for p in self._pieces), default=0)
        self._min_score = min(self._scores, default=0.0)
        self._unk_id = 3  # GemmaConverter.unk_id
        # CONTROL and USER_DEFINED pieces, matched whole in the raw text.
        self._added: dict[str, int] = {}
        self._added_by_id: dict[int, str] = {}
        for p, _, kind in model.pieces:
            if kind in (CONTROL, USER_DEFINED) and p not in self._added:
                tid = self._ids.get(p, len(self._pieces) + len(self._added))
                self._added[p] = tid
                self._added_by_id.setdefault(tid, p)
        alts = sorted((p for p in self._added if p), key=len, reverse=True)
        self._added_re = re.compile("|".join(map(re.escape, alts))) \
            if alts else None
        self._merges = None
        if model.model_type == BPE:
            self._merges = self._bpe_merges([p for p, _, _ in model.pieces],
                                            vocab)
            unk = model.unk_piece
            if unk not in self._ids:
                raise ValueError(f"BPE unk piece {unk!r} is not a piece")
            self._bpe_unk = self._ids[unk]

    # --- encode ---

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        pos = 0
        for m in (self._added_re.finditer(text) if self._added_re else ()):
            if m.start() > pos:
                ids += self._model_ids(text[pos:m.start()])
            ids.append(self._added[m.group()])
            pos = m.end()
        if pos < len(text):
            ids += self._model_ids(text[pos:])
        return ids

    def _model_ids(self, segment: str) -> list[int]:
        s = segment.replace(" ", SPACE)
        if self._merges is not None:
            return self._bpe(s)
        ids: list[int] = []
        for piece in self._viterbi(s):
            tid = self._ids.get(piece)
            if tid is None:
                fallback = [self._ids.get(f"<0x{b:02X}>")
                            for b in piece.encode("utf-8")]
                if all(t is not None for t in fallback):
                    ids += fallback
                    continue
                tid = self._unk_id
            ids.append(tid)
        return ids

    def _viterbi(self, s: str) -> list[str]:
        """The best segmentation of s into pieces (tokenizers'
        Unigram::encode_optimized); unknown nodes fuse into one string."""
        n = len(s)
        ids, scores, unk_id = self._ids, self._scores, self._unk_id
        unk_score = self._min_score - UNK_PENALTY
        best = [0.0] * (n + 1)
        start: list = [None] * (n + 1)
        node = [0] * (n + 1)
        for i in range(n):
            base = best[i]
            single = False
            for length in range(1, min(self._max_len, n - i) + 1):
                tid = ids.get(s[i:i + length])
                if tid is None:
                    continue
                j = i + length
                cand = scores[tid] + base
                if start[j] is None or cand > best[j]:
                    best[j], start[j], node[j] = cand, i, tid
                if length == 1:
                    single = True
            if not single:
                cand = unk_score + base
                if start[i + 1] is None or cand > best[i + 1]:
                    best[i + 1], start[i + 1], node[i + 1] = cand, i, unk_id
        out: list[str] = []
        fused: list[str] = []
        j = n
        while j > 0:
            i = start[j]
            if node[j] == unk_id:
                fused.append(s[i:j])
            else:
                if fused:
                    out.append("".join(reversed(fused)))
                    fused = []
                out.append(s[i:j])
            j = i
        if fused:
            out.append("".join(reversed(fused)))
        out.reverse()
        return out

    def _bpe_merges(self, raw: list[str], vocab: list) -> dict:
        """{(left id, right id): (rank, merged id)}: GemmaSentencePiece-
        Extractor's merges (generate_merges, ordered by piece score)."""
        ext = {p: i for i, p in enumerate(raw)}
        if "\t" not in ext:
            ext["\t"] = ext.get("<0x09>")
        merges = []
        for piece, score in dict(vocab).items():
            local = [(piece[:k], piece[k:], score)
                     for k in range(1, len(piece))
                     if piece[:k] in ext and piece[k:] in ext]
            local.sort(key=lambda x: (ext[x[0]], ext[x[1]]))
            merges.extend(local)
        merges.sort(key=lambda v: (v[2], len(v[0]), len(v[1])), reverse=True)
        table = {}
        for rank, (a, b, _) in enumerate(merges):
            try:
                table[self._ids[a], self._ids[b]] = (rank, self._ids[a + b])
            except KeyError as e:
                raise ValueError(f"BPE merge ({a!r}, {b!r}): {e} is not a "
                                 "piece") from e
        return table

    def _bpe(self, s: str) -> list[int]:
        """tokenizers' BPE merge_word + Word::merge_all (byte fallback,
        fused unknowns, no dropout)."""
        ids = self._ids
        syms: list[int] = []
        unk = None
        for ch in s:
            tid = ids.get(ch)
            if tid is not None:
                if unk is not None:
                    syms.append(unk)
                    unk = None
                syms.append(tid)
                continue
            fallback = [ids.get(f"<0x{b:02X}>") for b in ch.encode("utf-8")]
            if all(t is not None for t in fallback):
                syms += fallback  # a pending unknown stays pending
                continue
            unk = self._bpe_unk
        if unk is not None:
            syms.append(unk)
        n = len(syms)
        merges = self._merges
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n)) + [-1]
        alive = [True] * n
        heap = []
        for pos in range(n - 1):
            m = merges.get((syms[pos], syms[pos + 1]))
            if m is not None:
                heap.append((m[0], pos, m[1]))
        heapq.heapify(heap)
        while heap:
            rank, pos, new_id = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] == -1:
                continue
            right = nxt[pos]
            m = merges.get((syms[pos], syms[right]))
            if m is None or m[1] != new_id:
                continue
            syms[pos] = new_id
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[right] != -1:
                prev[nxt[right]] = pos
            if prev[pos] >= 0:
                m = merges.get((syms[prev[pos]], new_id))
                if m is not None:
                    heapq.heappush(heap, (m[0], prev[pos], m[1]))
            if nxt[pos] != -1:
                m = merges.get((new_id, syms[nxt[pos]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [t for t, a in zip(syms, alive) if a]

    # --- decode ---

    def id_to_piece(self, token_id: int) -> str:
        piece = self._added_by_id.get(token_id)
        if piece is None and 0 <= token_id < len(self._pieces):
            piece = self._pieces[token_id]
        return piece or ""

    def decode(self, ids: Sequence[int]) -> str:
        out: list[str] = []
        run = bytearray()

        def flush():
            if run:
                try:
                    out.append(run.decode("utf-8"))
                except UnicodeDecodeError:
                    out.append("�" * len(run))
                run.clear()

        for tid in ids:
            piece = self.id_to_piece(int(tid))
            if not piece:
                continue
            piece = piece.replace(SPACE, " ")
            b = _byte_of(piece)
            if b is not None:
                run.append(b)
                continue
            flush()
            out.append(piece)
        flush()
        return "".join(out)


class GemmaTokenizer:
    """SentencePiece model proto -> ids and back (module docstring)."""

    def __init__(self, proto: bytes | None):
        self._proto = proto or MOCK_TOKENIZER
        self._spm = None
        self._reader = None
        if self._proto == MOCK_TOKENIZER:
            return
        try:
            import sentencepiece  # type: ignore

            self._spm = sentencepiece.SentencePieceProcessor()
            self._spm.LoadFromSerializedProto(self._proto)
            return
        except ImportError:
            pass
        self._reader = SpmReader(parse_model_proto(self._proto))

    @property
    def available(self) -> bool:
        return self._spm is not None or self._reader is not None

    def serialize(self) -> bytes:
        return self._proto

    def encode(self, text: str) -> list[int]:
        """Text -> ids, no BOS/EOS (SentencePieceProcessor::Encode)."""
        if self._spm is not None:
            return list(self._spm.EncodeAsIds(text))
        if self._reader is not None:
            return self._reader.encode(text)
        return []

    def decode(self, ids: Sequence[int]) -> str:
        if self._spm is not None:
            return self._spm.DecodeIds(list(ids))
        if self._reader is not None:
            return self._reader.decode(ids)
        return ""

    def id_to_piece(self, token_id: int) -> str:
        if self._spm is not None:
            return self._spm.IdToPiece(token_id)
        if self._reader is not None:
            return self._reader.id_to_piece(token_id)
        return ""


class ChatTemplate:
    """GemmaChatTemplate (gemma/tokenizer.cc:108-173)."""

    def __init__(self, tokenizer: GemmaTokenizer):
        self.sot_user = tokenizer.encode("<start_of_turn>user\n")
        self.sot_model = tokenizer.encode("<start_of_turn>model\n")
        self.eot = tokenizer.encode("<end_of_turn>\n")
        self.pali_sep = tokenizer.encode("\n")
        self.vlm_soi = tokenizer.encode("\n\n<start_of_image>")
        self.vlm_eoi = tokenizer.encode("<end_of_image>\n\n")

    def apply(self, pos: int, ids: Sequence[int]) -> list[int]:
        """BOS/eot continuation + user turn + model turn header."""
        out = [BOS_ID] if pos == 0 else list(self.eot)
        out += self.sot_user
        out += list(ids)
        out += self.eot
        out += self.sot_model
        return out

    def wrap_pali(self, text_ids: Sequence[int],
                  image_batch_size: int) -> list[int]:
        """image_batch_size zero-tokens, BOS, text, separator (prefix-LM)."""
        return [0] * image_batch_size + [BOS_ID] + list(text_ids) + self.pali_sep

    def wrap_vlm(self, text_ids: Sequence[int],
                 image_batch_size: int) -> list[int]:
        """text + <start_of_image> + -2 placeholders + <end_of_image>."""
        return (list(text_ids) + self.vlm_soi + [-2] * image_batch_size
                + self.vlm_eoi)


def wrap_and_tokenize(
    tokenizer: GemmaTokenizer,
    template: ChatTemplate,
    wrapping: PromptWrapping,
    pos: int,
    prompt: str,
    image_batch_size: int | None = None,
) -> list[int]:
    """WrapAndTokenize (gemma/tokenizer.cc:176-218)."""
    ids = tokenizer.encode(prompt)
    if image_batch_size is not None:
        if wrapping == PromptWrapping.PALIGEMMA:
            assert pos == 0
            return template.wrap_pali(ids, image_batch_size)
        if wrapping == PromptWrapping.GEMMA_VLM:
            return template.apply(pos, template.wrap_vlm(ids, image_batch_size))
        raise ValueError("variant does not support vision prompts")
    if wrapping in (PromptWrapping.GEMMA_IT, PromptWrapping.GEMMA_VLM):
        return template.apply(pos, ids)
    if pos == 0:
        return [BOS_ID] + ids
    return ids
