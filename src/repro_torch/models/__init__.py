"""The LM substrate's dense GQA model: embeddings, attention, MLP, blocks."""
