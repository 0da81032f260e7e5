"""The yardstick's arithmetic: the card's peaks, the hand-written kernels'
names by layer, and the bytes each layer moves at its boundary."""
