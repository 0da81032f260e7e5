"""Across devices: the row-tile and spp splits of a frame (``sharding``)."""
