"""Operation and byte counts of the required work, from a configuration's
shapes, and the chip's published peaks."""
