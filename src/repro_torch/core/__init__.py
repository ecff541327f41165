"""Core structures of the port: ranking, element codecs (types), RoomyArray,
packed bit arrays, the hash table, owner maps, the bucket exchange
(delayed), constructs, paged KV caches, obs."""
