"""Byte-level BPE tokenizer (GPT-2/BART vocabulary format), owned in-repo.

Parity target: the ``BartTokenizer`` the reference pulls from transformers
3.0.2 (src/data/tokenization.py:2,32): byte-to-unicode mapping, greedy pair
merging over ``merges.txt`` ranks, the GPT-2 splitting regex, added special
tokens that are never split, ``decode`` with HF's tokenization-space cleanup,
and ``get_special_tokens_mask`` semantics used by MLM masking
(src/data/collation.py:229).

Assets: a ``vocab.json`` + ``merges.txt`` pair (the published BART files
drop in unchanged). ``build_toy_assets`` writes a tiny merge-free
byte-vocabulary for tests/offline use.
"""

import json
import os
from functools import lru_cache

import regex as re

# GPT-2 split pattern (contractions, letter runs, digit runs, punctuation,
# trailing whitespace handling)
_PAT = re.compile(
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
)


@lru_cache()
def bytes_to_unicode():
    """GPT-2's reversible byte <-> printable-unicode mapping."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


class ByteLevelBPE:
    """Encoder/decoder over a vocab.json + merges.txt pair.

    Special/added tokens are split out of the text before BPE and are never
    merged (HF added-token semantics).
    """

    def __init__(self, vocab_file, merges_file, *, bos_token="<s>",
                 eos_token="</s>", pad_token="<pad>", unk_token="<unk>",
                 mask_token="<mask>"):
        with open(vocab_file, encoding="utf-8") as f:
            self.encoder = json.load(f)
        self.decoder = {v: k for k, v in self.encoder.items()}
        with open(merges_file, encoding="utf-8") as f:
            merges = f.read().split("\n")
        if merges and merges[0].startswith("#"):
            merges = merges[1:]
        merges = [tuple(m.split()) for m in merges if m and len(m.split()) == 2]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))

        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self._cache = {}

        self.bos_token, self.eos_token = bos_token, eos_token
        self.pad_token, self.unk_token = pad_token, unk_token
        self.mask_token = mask_token
        self.added_tokens = {}          # token -> id (appended after vocab)
        self.added_ids = {}             # id -> token
        self._special_tokens = {bos_token, eos_token, pad_token, unk_token,
                                mask_token}
        self._split_re = None

    # -- vocabulary ---------------------------------------------------------

    @property
    def vocab_size(self):
        return len(self.encoder)

    def __len__(self):
        return len(self.encoder) + len(self.added_tokens)

    def add_special_tokens(self, tokens):
        """Append never-split special tokens after the base vocab (HF ids
        50265.. for BART: src/data/tokenization.py:36-57)."""
        for tok in tokens:
            if tok not in self.added_tokens and tok not in self.encoder:
                idx = len(self.encoder) + len(self.added_tokens)
                self.added_tokens[tok] = idx
                self.added_ids[idx] = tok
            self._special_tokens.add(tok)
        self._split_re = None

    def convert_tokens_to_ids(self, tokens):
        single = isinstance(tokens, str)
        if single:
            tokens = [tokens]
        unk = self.encoder.get(self.unk_token, 0)
        out = [self.added_tokens.get(t, self.encoder.get(t, unk)) for t in tokens]
        return out[0] if single else out

    def convert_ids_to_tokens(self, ids):
        single = isinstance(ids, int)
        if single:
            ids = [ids]
        out = [self.added_ids.get(i, self.decoder.get(i, self.unk_token)) for i in ids]
        return out[0] if single else out

    @property
    def all_special_ids(self):
        ids = set(self.added_ids)
        for t in self._special_tokens:
            if t in self.encoder:
                ids.add(self.encoder[t])
        return ids

    def get_special_tokens_mask(self, ids):
        special = self.all_special_ids
        return [1 if i in special else 0 for i in ids]

    # -- BPE ------------------------------------------------------------------

    def _bpe(self, token):
        if token in self._cache:
            return self._cache[token]
        word = tuple(token)
        pairs = get_pairs(word) if len(word) > 1 else None
        if not pairs:
            return token
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def _split_specials(self, text):
        """Split text around added/special tokens (never-split semantics)."""
        if self._split_re is None:
            toks = sorted(self._special_tokens | set(self.added_tokens),
                          key=len, reverse=True)
            self._split_re = re.compile(
                "(" + "|".join(re.escape(t) for t in toks) + ")")
        return self._split_re.split(text)

    def tokenize(self, text):
        tokens = []
        for piece in self._split_specials(text):
            if not piece:
                continue
            if piece in self._special_tokens or piece in self.added_tokens:
                tokens.append(piece)
                continue
            for word in _PAT.findall(piece):
                word = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
                tokens.extend(self._bpe(word).split(" "))
        return tokens

    def encode(self, text):
        """Text -> list[int] with NO <s>/</s> wrapping (the reference always
        calls with add_special_tokens=False and builds markers in the text)."""
        return self.convert_tokens_to_ids(self.tokenize(text))

    # -- decoding ---------------------------------------------------------------

    def _tokens_to_text(self, tokens):
        text = "".join(tokens)
        return bytearray(self.byte_decoder.get(c, ord(" ")) for c in text
                         ).decode("utf-8", errors="replace")

    def decode(self, ids, skip_special_tokens=False,
               clean_up_tokenization_spaces=True):
        special = self.all_special_ids
        sub_texts = []
        current = []
        for i in ids:
            i = int(i)
            if i in special:
                if current:
                    sub_texts.append(self._tokens_to_text(
                        self.convert_ids_to_tokens(current)))
                    current = []
                if not skip_special_tokens:
                    sub_texts.append(self.convert_ids_to_tokens(i))
            else:
                current.append(i)
        if current:
            sub_texts.append(self._tokens_to_text(
                self.convert_ids_to_tokens(current)))
        text = " ".join(sub_texts) if not skip_special_tokens else "".join(sub_texts)
        if clean_up_tokenization_spaces:
            text = self.clean_up_tokenization(text)
        return text

    @staticmethod
    def clean_up_tokenization(text):
        """HF PreTrainedTokenizer.clean_up_tokenization (3.0.2)."""
        return (text.replace(" .", ".").replace(" ?", "?").replace(" !", "!")
                .replace(" ,", ",").replace(" ' ", "' ").replace(" n't", "n't")
                .replace(" 'm", "'m").replace(" 's", "'s").replace(" 've", "'ve")
                .replace(" 're", "'re"))


def build_toy_assets(directory, extra_words=()):
    """Write a tiny merge-free byte vocabulary (for tests / offline runs).

    Layout mirrors BART: <s>=0, <pad>=1, </s>=2, <unk>=3, then the 256 byte
    symbols, optional whole-word tokens, <mask> last.
    """
    os.makedirs(directory, exist_ok=True)
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for ch in bytes_to_unicode().values():
        vocab.setdefault(ch, len(vocab))
    for w in extra_words:
        vocab.setdefault(w, len(vocab))
    vocab["<mask>"] = len(vocab)
    vocab_file = os.path.join(directory, "vocab.json")
    merges_file = os.path.join(directory, "merges.txt")
    with open(vocab_file, "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(merges_file, "w") as f:
        f.write("#version: toy\n")
    return vocab_file, merges_file
