"""Serving surface of the port: the ANN micro-batching service."""

from .ann_service import AddTicket, AnnService, BatchPolicy, Ticket

__all__ = ["AnnService", "AddTicket", "BatchPolicy", "Ticket"]
