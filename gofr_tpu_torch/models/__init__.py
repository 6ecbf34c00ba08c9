"""Models: the Llama decoder, its weight bridge, and the serving tokenizers."""
