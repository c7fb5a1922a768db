from .events import detect_events, get_events, EventTable
from .jnn import find_adaptor, find_polya, detect_query_start
