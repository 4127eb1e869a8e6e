"""One driver a kind of traffic, named by the traffic file's ``kind``."""
