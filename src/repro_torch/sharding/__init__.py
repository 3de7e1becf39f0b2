"""The state's layout over a mesh: the reference's partition rules as
``DTensor`` placements (``sharding.partition``)."""
