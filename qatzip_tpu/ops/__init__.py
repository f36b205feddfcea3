"""Device compute kernels (the "ASIC" of this framework).

Pallas/JAX implementations of the codec hot ops: LZ77 match finding,
DEFLATE Huffman encode/decode, LZ4/LZ4s block codecs, CRC32/Adler32/XXH32
checksums.  `registry` maps session params to available device codecs.
"""
