"""Tokenization SPI.

The port's copy of `deeplearning4j_tpu/nlp/tokenization.py`, which is host code
(Python and numpy) and computes the same.

Equivalent of the reference's `text/tokenization/` (TokenizerFactory/Tokenizer
SPI + CommonPreprocessor/EndingPreProcessor). The reference ships UIMA/Kuromoji
language packs as separate modules; here the SPI accepts any callable so
language-specific tokenizers plug in the same way.
"""

from __future__ import annotations

import re
from typing import Callable, Iterable, List, Optional


class TokenPreProcess:
    """Token normalizer SPI (reference: `CommonPreprocessor.java`)."""

    def pre_process(self, token: str) -> str:
        raise NotImplementedError


class CommonPreprocessor(TokenPreProcess):
    _strip = re.compile(r"[\d\.:,\"'\(\)\[\]|/?!;]+")

    def pre_process(self, token: str) -> str:
        return self._strip.sub("", token).lower()


class EndingPreProcessor(TokenPreProcess):
    """Crude stemmer (reference: `EndingPreProcessor.java`)."""

    def pre_process(self, token: str) -> str:
        for suffix in ("sses", "ies", "ing", "ed", "s"):
            if token.endswith(suffix) and len(token) > len(suffix) + 2:
                return token[: -len(suffix)]
        return token


class Tokenizer:
    def __init__(self, tokens: List[str]):
        self._tokens = tokens

    def get_tokens(self) -> List[str]:
        return list(self._tokens)

    def count_tokens(self) -> int:
        return len(self._tokens)


class TokenizerFactory:
    """Default whitespace tokenizer factory (reference:
    `DefaultTokenizerFactory.java`)."""

    def __init__(self, preprocessor: Optional[TokenPreProcess] = None):
        self.preprocessor = preprocessor

    def create(self, text: str) -> Tokenizer:
        toks = text.split()
        if self.preprocessor is not None:
            toks = [self.preprocessor.pre_process(t) for t in toks]
        return Tokenizer([t for t in toks if t])


DefaultTokenizerFactory = TokenizerFactory


def tokenize_corpus(sentences, tokenizer_factory: "TokenizerFactory") -> List[List[str]]:
    """Tokenize a corpus of raw strings and/or pre-split token lists (the
    shared sentence-ingest step of every embedding trainer — reference:
    `SentenceTransformer` feeding `SequenceVectors`)."""
    corpus = []
    for s in sentences:
        if isinstance(s, str):
            corpus.append(tokenizer_factory.create(s).get_tokens())
        else:
            corpus.append(list(s))
    return corpus
