"""BAM / BAI / BED / TSV I/O of the port, over its own C++ host library
(``csrc/``, built by ``build.build_bamio``, bound by ``_native.host_lib``)."""
