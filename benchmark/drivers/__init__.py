"""The general generators, one per kind of traffic. A traffic file names
its driver under ``"driver"``; the driver reads every parameter of the mix
from that file."""
