"""Format-aware engines of the host oracle: lexer, parse tree, JSON,
SGML, fuse, length-field/checksum and ZIP (copies of the JAX package's
pure-Python models, imported by oracle/mutations.py and
oracle/patterns.py), and the HTTP/2 framer with its HPACK and Huffman
codecs (http2.py, hpack.py, huffman.py), which the fuzzing proxy's
http2:// path runs."""
