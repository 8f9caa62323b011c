from .engine import Request, ServeEngine
from .kvcache import PagedKVCache, gather_pages
from .router import BassRouter, RouteDecision
