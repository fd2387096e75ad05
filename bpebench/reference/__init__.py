"""The benchmark's plain reference: byte-level BPE training and encoding
and the GPT-4 pre-split, written from the minbpe contract alone. It imports
nothing of the program under test, nor JAX."""
