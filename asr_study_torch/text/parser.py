"""Character-level label parsing with PT-BR normalization.

Copied from ``asr_study_tpu/text/parser.py`` so that the port imports
nothing of the JAX package; standard library and numpy only.

Mirrors the reference's char parser [ref: preprocessing/text.py]: sentence ->
int label ids and back, lowercasing, accent stripping (the reference uses
``unidecode``; we use NFKD decomposition + combining-mark removal, which is
equivalent for Portuguese), and a validity filter for out-of-vocabulary
sentences.  Blank handling is left to CTC: ids are 0..V-1 and the CTC blank is
index V (appended by the model's output layer).
"""

from __future__ import annotations

import string
import unicodedata
from typing import List

PT_BR_VOCAB = string.ascii_lowercase + " "
# SURVEY.md §2.1 tags the reference's vocabulary as "a-z + space
# (+ apostrophe)" with MED confidence on the apostrophe; both variants are
# first-class so parity is a flag flip at dataset build, not a rebuild.
PT_BR_APOSTROPHE_VOCAB = PT_BR_VOCAB + "'"

VOCAB_PRESETS = {
    "pt_br": PT_BR_VOCAB,
    "pt_br_apostrophe": PT_BR_APOSTROPHE_VOCAB,
}


def resolve_vocab(spec: str | None) -> str:
    """CLI ``--vocab`` value -> vocabulary string.

    Accepts a preset name (``pt_br``, ``pt_br_apostrophe``) or a literal
    character string (must contain no duplicates).  None -> the default.
    """
    if spec is None or spec == "":
        return PT_BR_VOCAB
    if spec in VOCAB_PRESETS:
        return VOCAB_PRESETS[spec]
    if len(set(spec)) != len(spec):
        raise ValueError(f"--vocab has duplicate characters: {spec!r}")
    return spec


def normalize_text(sentence: str) -> str:
    """Lowercase and strip accents/diacritics (ã->a, ç->c, é->e, ...)."""
    sentence = sentence.lower()
    decomposed = unicodedata.normalize("NFKD", sentence)
    return "".join(c for c in decomposed if not unicodedata.combining(c))


class CharParser:
    """sentence <-> int id sequence.

    >>> p = CharParser()
    >>> p("não")          # accent-normalized
    array([13,  0, 14], dtype=int32)
    >>> p.imap(p("oi tudo"))
    'oi tudo'
    """

    def __init__(self, vocab: str = PT_BR_VOCAB, normalize: bool = True):
        if len(set(vocab)) != len(vocab):
            raise ValueError(f"vocab has duplicate characters: {vocab!r}")
        self.vocab = vocab
        self.normalize = normalize
        self.char_to_id = {c: i for i, c in enumerate(vocab)}
        self.id_to_char = {i: c for i, c in enumerate(vocab)}

    @property
    def num_classes(self) -> int:
        """Number of real labels (CTC blank NOT included)."""
        return len(self.vocab)

    @property
    def blank_id(self) -> int:
        """The CTC blank index used by models built on this parser."""
        return len(self.vocab)

    def _clean(self, sentence: str) -> str:
        if self.normalize:
            sentence = normalize_text(sentence)
        # collapse whitespace runs
        sentence = " ".join(sentence.split())
        return sentence

    def is_valid(self, sentence: str) -> bool:
        cleaned = self._clean(sentence)
        return len(cleaned) > 0 and all(c in self.char_to_id for c in cleaned)

    def map(self, sentence: str) -> "list[int]":
        import numpy as np

        cleaned = self._clean(sentence)
        return np.array(
            [self.char_to_id[c] for c in cleaned if c in self.char_to_id],
            dtype=np.int32,
        )

    def imap(self, ids) -> str:
        return "".join(self.id_to_char[int(i)] for i in ids if int(i) in self.id_to_char)

    def imap_batch(self, ids_batch, lengths=None) -> List[str]:
        out = []
        for row_i, row in enumerate(ids_batch):
            if lengths is not None:
                row = row[: int(lengths[row_i])]
            out.append(self.imap(row))
        return out

    def __call__(self, sentence: str):
        return self.map(sentence)

    def __str__(self) -> str:
        return "char"
