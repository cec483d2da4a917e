from .table import Catalog, Database, Part, Table
