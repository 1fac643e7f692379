"""The port's operator tools: the schedule fuzzer (``tools.fuzz``) and
the client-load harness (``tools.loadgen``), copies of the reference's
``tools/fuzz.py`` and ``tools/loadgen.py`` whose clusters take the
port's defaults (the crypto on the card)."""
