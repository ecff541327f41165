"""Core structures of the port: ranking, element codecs (types), RoomyArray,
RoomyList (rlist), RoomySet (rset), packed bit arrays, the hash table,
owner maps, the bucket exchange (delayed), constructs (the set
operations, chain/prefix/pair reduction, the sorted-list and implicit
BFS), paged KV caches, obs."""
