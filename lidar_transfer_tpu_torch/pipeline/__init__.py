"""Transfer pipeline: scan windows, the transfer engine, the writer."""
