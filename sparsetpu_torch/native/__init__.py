"""Native (C++) host runtime behind ctypes: the matrix loader, the pack
engine and the final-level builder.  ``loader.py`` builds the library from
this directory's sources into ``build/sparsetpu_torch/native/``."""
