"""The plain reference renderer that decides `correct`: plain PyTorch from
a configuration's description and an image's seed, importing nothing of
the renderer under test."""
