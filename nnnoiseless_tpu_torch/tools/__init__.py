"""Developer tools of the port: parity checking (``corr``), the sine
benchmark and profiler trace (``profile``), per-frame pitch traces against
the native engine (``trace``), and engine attribution on the card
(``attrib``)."""
