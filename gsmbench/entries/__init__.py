"""Entry points of the renderer that cells drive, one module each."""
