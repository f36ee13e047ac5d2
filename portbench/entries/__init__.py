"""The entries the benchmark drives, one module each, found by the name
that a traffic file gives (``"entry"``). Each defines ``Cell``, a
``cells.EncodeCell`` or ``cells.DecodeCell`` with the timed ``call``."""
