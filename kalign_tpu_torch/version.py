__version__ = "0.1.0"

# Version string of the reference implementation whose behavior we match.
# Used by the Clustal/MSF writers for byte-compatible headers.
KALIGN_COMPAT_VERSION = "3.5.1"
