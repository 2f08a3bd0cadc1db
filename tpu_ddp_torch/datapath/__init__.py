"""The host data path's staged prefetcher (``datapath/prefetch.py``)."""
