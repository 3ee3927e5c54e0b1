"""NLP and embeddings (counterpart of `deeplearning4j_tpu/nlp/`):
tokenization, vocab, Word2Vec, ParagraphVectors, GloVe, the word-vector
serializers, the vectorizers and the distributed corpus pipeline."""
