"""aiohttp middleware serving HTTP error pages from templates
(reference error_pages.py, modernized to aiohttp 3 middleware style); a
copy of style_transfer2_tpu/serve/error_pages.py."""

from aiohttp import web

from .render import render

MESSAGES = {
    503: 'Style Transfer is temporarily unavailable due to high load. If you '
         'refresh the page or come back in about a minute, it might be '
         'available.',
}

TEMPLATE = 'error.html'


def error_pages(template_vars=None):
    """Returns an aiohttp middleware rendering any >=400 response or
    HTTPException through the error template."""
    template_vars = template_vars or {}

    @web.middleware
    async def middleware(request, handler):
        try:
            response = await handler(request)
        except web.HTTPException as err:
            response = err
        status = getattr(response, 'status', 200)
        if status >= 400:
            context = dict(status_code=status,
                           reason=getattr(response, 'reason', ''),
                           message=MESSAGES.get(status, ''))
            context.update(template_vars)
            return render(TEMPLATE, context, status=status)
        return response

    return middleware
