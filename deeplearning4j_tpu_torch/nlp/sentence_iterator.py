"""Sentence / document iterators.

The port's copy of `deeplearning4j_tpu/nlp/sentence_iterator.py`, which is host code
(Python and numpy) and computes the same.

Equivalent of the reference's `text/sentenceiterator/` (BasicLineIterator,
CollectionSentenceIterator, FileSentenceIterator) and the labelled document
iterators used by ParagraphVectors (`text/documentiterator/LabelledDocument`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Iterable, Iterator, List, Optional


class SentenceIterator:
    def __iter__(self) -> Iterator[str]:
        raise NotImplementedError

    def reset(self) -> None:
        pass


class CollectionSentenceIterator(SentenceIterator):
    def __init__(self, sentences: Iterable[str]):
        self._sentences = list(sentences)

    def __iter__(self):
        return iter(self._sentences)


class BasicLineIterator(SentenceIterator):
    """One sentence per line from a text file (reference: `BasicLineIterator.java`)."""

    def __init__(self, path: str):
        self.path = path

    def __iter__(self):
        with open(self.path, "r", encoding="utf-8", errors="replace") as f:
            for line in f:
                line = line.strip()
                if line:
                    yield line


class FileSentenceIterator(SentenceIterator):
    """All lines of all files under a directory (reference: `FileSentenceIterator.java`)."""

    def __init__(self, directory: str):
        self.directory = directory

    def __iter__(self):
        for root, _, files in os.walk(self.directory):
            for name in sorted(files):
                yield from BasicLineIterator(os.path.join(root, name))


@dataclass
class LabelledDocument:
    """Document with labels (reference: `text/documentiterator/LabelledDocument.java`)."""

    content: str = ""
    labels: List[str] = field(default_factory=list)


class LabelAwareIterator:
    def __iter__(self) -> Iterator[LabelledDocument]:
        raise NotImplementedError

    def reset(self):
        pass


class SimpleLabelAwareIterator(LabelAwareIterator):
    def __init__(self, documents: Iterable[LabelledDocument]):
        self._docs = list(documents)

    def __iter__(self):
        return iter(self._docs)
