"""Plain float32 PyTorch references of the served models.

They import nothing of the program under test: every equation is
written out here again (RMSNorm, split-halves RoPE, attention, the
top-k router, SwiGLU experts, the shared experts, the readout), and the
cache is worked out again from the tokens. A reference module exposes
``layer(p, x, positions, cfg, mm)`` and the shared ``forward`` in
``common`` runs the model layer by layer, so that one layer's weights
at a time are held in float32.
"""
