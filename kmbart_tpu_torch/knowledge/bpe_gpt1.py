"""OpenAI GPT-1 (COMET) subword BPE text encoder.

Parity target: the comet-commonsense text encoder (``TextEncoder`` in the
submodule): lowercase, simple word tokenisation, word-level BPE with the
``</w>`` end-of-word marker over a 40k merge table. The reference's
pipeline additionally runs ftfy + spaCy; this implementation uses a
regex word splitter that agrees on ordinary English caption text
(deviation documented per SURVEY.md §7).
"""

import json
import re

import regex

_WORD_RE = regex.compile(r"\w+|[^\w\s]", regex.UNICODE)


def text_standardize(text):
    """comet-commonsense utils.text_standardize."""
    text = text.replace("—", "-").replace("–", "-").replace("―", "-")
    text = text.replace("…", "...").replace("´", "'")
    text = re.sub(r"""(-+|~+|!+|"+|;+|\?+|\++|,+|\)+|\(+|\\+|\/+|\*+|\[+|\]+|}+|{+|\|+|_+)""",
                  r" \1 ", text)
    text = re.sub(r"\s*\n\s*", " \n ", text)
    text = re.sub(r"[^\S\n]+", " ", text)
    return text.strip()


def _get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


class GPT1BPE:
    def __init__(self, vocab_file, merges_file):
        with open(vocab_file, encoding="utf-8") as f:
            self.encoder = json.load(f)
        self.decoder = {v: k for k, v in self.encoder.items()}
        with open(merges_file, encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(m.split()) for m in lines[1:] if m and len(m.split()) == 2]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self._cache = {}

    def _bpe(self, token):
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word) if len(word) > 1 else None
        if not pairs:
            return token + "</w>"
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
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text):
        ids = []
        for tok in _WORD_RE.findall(text_standardize(text.lower())):
            for piece in self._bpe(tok).split(" "):
                if piece in self.encoder:
                    ids.append(self.encoder[piece])
        return ids

    def decode(self, ids, stop_ids=()):
        words = []
        for i in ids:
            i = int(i)
            if i in stop_ids:
                break
            words.append(self.decoder.get(i, ""))
        return "".join(words).replace("</w>", " ").strip()
